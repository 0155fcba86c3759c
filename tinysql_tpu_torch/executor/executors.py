"""Volcano executors over chunks (CPU path).

Capability parity with reference executor/: Executor iface Open/Next/Close
(executor.go:146-152), SelectionExec :346 (vectorized filter — the course
stub :396 implemented for real), TableReader (table_reader.go),
HashJoinExec (join.go — build :149 / probe :244 stubs implemented),
HashAggExec (aggregate.go — shuffle :355 / consume :425 stubs implemented),
SortExec/TopNExec (sort.go), ProjectionExec, LimitExec, TableDualExec.
The numpy-vectorized inner loops are the CPU fallback tier; the TPU tier
(executor/tpu_executors.py per-operator kernels, executor/devpipe.py
whole-subtree device pipelines) swaps in behind the same interface.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import fail
from ..catalog.table import Table
from ..utils import interrupt
from ..chunk import Chunk, MAX_CHUNK_SIZE
from ..expression import Schema, vectorized_filter
from ..mytypes import EvalType, sort_key
from ..planner.builder import HANDLE_COL_NAME
from ..planner.physical import (PhysicalHashAgg, PhysicalHashJoin,
                                PhysicalIndexLookUpReader,
                                PhysicalIndexReader, PhysicalLimit,
                                PhysicalMergeJoin, PhysicalPlan,
                                PhysicalProjection, PhysicalSelection,
                                PhysicalSort, PhysicalTableDual,
                                PhysicalTableReader, PhysicalTopN)
from .aggfuncs import new_state


class ExecContext:
    """Per-statement execution context (reference: sessionctx threading)."""

    def __init__(self, txn, session_vars=None, infoschema=None, storage=None):
        self.txn = txn
        self.session_vars = session_vars or {}
        self.infoschema = infoschema
        self.storage = storage

    @property
    def max_chunk_size(self) -> int:
        return int(self.session_vars.get("tidb_max_chunk_size", MAX_CHUNK_SIZE))


class Executor:
    def __init__(self, schema: Schema, children: List["Executor"]):
        self.schema = schema
        self.children = children

    def field_types(self):
        return self.schema.field_types()

    def open(self, ctx: ExecContext) -> None:
        self.ctx = ctx
        for c in self.children:
            c.open(ctx)

    def next(self) -> Optional[Chunk]:
        raise NotImplementedError

    def close(self) -> None:
        for c in self.children:
            c.close()

    def drain(self) -> List[list]:
        rows = []
        while True:
            # THE root block boundary: statement kill and the
            # max_execution_time deadline land between blocks here (the
            # all-consuming operators below add their own inner checks);
            # execSlowNext lets chaos tests stretch any statement
            interrupt.check()
            fail.inject("execSlowNext")
            chk = self.next()
            if chk is None:
                break
            rows.extend(chk.to_rows())
        return rows


class TableReaderExec(Executor):
    """Direct scan via the txn (reference: table_reader.go); the distsql
    layer's coprocessor readers supersede this on the distributed path."""

    def __init__(self, plan: PhysicalTableReader):
        super().__init__(plan.schema, [])
        self.scan = plan.scan
        self._iter = None

    FAST_CHUNK = 1 << 16  # columnar-replica slice size

    def open(self, ctx: ExecContext) -> None:
        super().open(ctx)
        info = self.scan.table_info
        self._tbl = Table(info)
        # decode set: the real columns in schema order (handle -> None)
        self._decode_cols = []
        for c in self.scan.schema.columns:
            if c.name == HANDLE_COL_NAME:
                self._decode_cols.append(None)
            else:
                ci = info.find_column(c.name)
                assert ci is not None, f"column {c.name} missing in {info.name}"
                self._decode_cols.append(ci)
        self._real_cols = [ci for ci in self._decode_cols if ci is not None]
        self._replica = None
        self._pos = 0
        self._iter = None
        self._cop = None
        self._cop_rest = None  # (batch, cursor) of a partially-emitted batch
        self._local_agg = None
        self._hydrate = None
        dirty = (ctx.txn is not None and ctx.storage is not None
                 and self._txn_dirty(ctx.txn, info.id))
        self._range_sel = None
        # columnar replica fast path (columnar/store.py) — full scans only;
        # ranged scans seek the row store directly
        if ctx.storage is not None and self.scan.ranges is None:
            from ..columnar.store import replica_for_read
            rep = replica_for_read(ctx.storage, ctx.txn, info.id)
            if rep is not None and all(ci.id in rep.columns
                                       for ci in self._real_cols):
                self._replica = rep
                if self.scan.pushed_agg is not None:
                    self._local_agg = True  # partial agg over replica chunks
                return
        # ranged (pk-predicate) scans over a replica-backed table: the
        # bulk loader writes ONLY the replica, so seeking the row store
        # would return nothing (the "l_id predicates return 0 rows"
        # bug) — serve the handle ranges from the replica instead.
        # Pushed aggregates ride the local partial-agg pass over the
        # gathered rows; pushed topn/limit are pre-cut hints the root
        # operators reapply, so serving them uncut stays correct.
        if ctx.storage is not None and self.scan.ranges is not None \
                and not dirty:
            from ..columnar.store import replica_for_read
            rep = replica_for_read(ctx.storage, ctx.txn, info.id)
            if rep is not None and all(ci.id in rep.columns
                                       for ci in self._real_cols):
                self._replica = rep
                self._range_sel = self._handle_range_positions(rep)
                if self.scan.pushed_agg is not None:
                    self._local_agg = True
                return
        if self.scan.pushed_agg is not None:
            # partial-agg reads: coprocessor path; a dirty txn falls back to
            # a local partial agg over the union-store scan (the UnionScan
            # analogue — own buffered writes must stay visible)
            if ctx.storage is not None and not dirty:
                self._cop = self._cop_select()
            else:
                self._iter = self._scan_iter(ctx.txn)
                self._local_agg = True
            return
        has_pushdown = (self.scan.filters or self.scan.ranges is not None
                        or self.scan.pushed_topn is not None
                        or self.scan.pushed_limit is not None)
        if ctx.storage is not None and not dirty and has_pushdown:
            # region scatter-gather with filter/topn/limit pushdown
            self._cop = self._cop_select()
            return
        self._iter = self._scan_iter(ctx.txn)
        if (ctx.storage is not None and not dirty
                and self.scan.ranges is None and self._real_cols):
            # pure full scan: hydrate the columnar replica as a side effect
            self._hydrate = {"handles": [], "rows": []}

    @staticmethod
    def _txn_dirty(txn, table_id: int) -> bool:
        from ..columnar.store import _txn_touches_table
        return _txn_touches_table(txn, table_id)

    def _scan_iter(self, txn):
        if self.scan.ranges is not None:
            return self._iter_ranges(txn)
        return self._tbl.iter_records(txn, cols=self._real_cols)

    def _cop_select(self):
        """Build the DAG request + key ranges and start the scatter-gather
        (reference: distsql.Select via RequestBuilder)."""
        from ..codec import tablecodec
        from ..distsql import DAGRequest, ScanInfo, select
        from ..distsql.exprpb import _ft_to_pb, exprs_to_pb
        info = self.scan.table_info
        pk = info.get_pk_handle_col()
        scan_info = ScanInfo(
            table_id=info.id,
            col_ids=[ci.id if ci is not None else -1
                     for ci in self._decode_cols],
            col_fts=[_ft_to_pb(c.ret_type)
                     for c in self.scan.schema.columns],
            col_defaults=[ci.default if ci is not None else None
                          for ci in self._decode_cols],
            handle_slots=[i for i, ci in enumerate(self._decode_cols)
                          if ci is None],
            pk_id=pk.id if pk is not None else None,
        )
        filters_pb = exprs_to_pb(self.scan.filters) if self.scan.filters \
            else None
        self._cop_filters_pushed = not self.scan.filters \
            or filters_pb is not None
        # topn/limit may only pre-cut AFTER all filters ran cop-side
        pre_cut_ok = self._cop_filters_pushed
        req = DAGRequest(
            start_ts=self.ctx.txn.start_ts,
            scan=scan_info,
            filters=filters_pb,
            agg=self.scan.pushed_agg,
            topn=self.scan.pushed_topn if pre_cut_ok else None,
            limit=self.scan.pushed_limit if pre_cut_ok else None,
        )
        if self.scan.ranges is not None:
            ranges = []
            for lo, hi in self.scan.ranges:
                ranges.append((tablecodec.encode_row_key(info.id, lo),
                               tablecodec.encode_row_key(info.id, hi)
                               + b"\x00"))
        else:
            ranges = [tablecodec.record_range(info.id)]
        conc = int(self.ctx.session_vars.get(
            "tidb_distsql_scan_concurrency", 15))
        return select(self.ctx.storage, req, ranges, conc)

    def _iter_ranges(self, txn):
        """Seek each [lo, hi] handle range directly (reference:
        distsql/request_builder.go handle-range table reads)."""
        from ..codec import tablecodec
        for lo, hi in self.scan.ranges:
            start = tablecodec.encode_row_key(self.scan.table_info.id, lo)
            end = tablecodec.encode_row_key(self.scan.table_info.id, hi) + b"\x00"
            for k, v in txn.iter_range(start, end):
                _, handle = tablecodec.decode_record_key(k)
                yield handle, self._tbl.decode_row(v, handle,
                                                   self._real_cols)

    def next(self) -> Optional[Chunk]:
        if self._cop is not None:
            return self._next_cop()
        if self._local_agg:
            return self._next_local_agg()
        if self._replica is not None:
            return self._apply_filters_or_none(self._next_fast_raw())
        return self._next_scan()

    def _apply_filters_or_none(self, chk):
        return None if chk is None else self._apply_filters(chk)

    def _next_cop(self) -> Optional[Chunk]:
        # one cop task returns a whole region's batch; emit it in
        # tidb_max_chunk_size slices so root drain-block boundaries
        # (kill / deadline checks, processlist progress) stay fine-
        # grained on large scans.  The leftover rides an integer cursor
        # (one slice copy per chunk, no quadratic re-slicing).  Pushed-
        # agg batches are tiny partial results and pass through whole.
        limit = max(self.ctx.max_chunk_size, 1)
        while True:
            if self._cop_rest is not None:
                rest, pos = self._cop_rest
                batch = rest[pos:pos + limit]
                pos += limit
                self._cop_rest = (rest, pos) if pos < len(rest) else None
            else:
                batch = next(self._cop, None)
                if batch is None:
                    self._cop = iter(())
                    return None
                if not batch:
                    continue
                if len(batch) > limit and self.scan.pushed_agg is None:
                    self._cop_rest = (batch, limit)
                    batch = batch[:limit]
            chk = Chunk(self.field_types(), cap=len(batch))
            for row in batch:
                chk.append_row(row)
            if (not self._cop_filters_pushed
                    and self.scan.pushed_agg is None):
                chk = self._apply_filters(chk)
                if chk.num_rows() == 0:
                    continue
            return chk

    def _next_local_agg(self) -> Optional[Chunk]:
        """Local partial aggregation over raw chunks — from the columnar
        replica or (dirty txn) the union-store scan.  Each slice gets one
        columnar pass (factorize + bincount straight into a Chunk, no
        per-row marshalling); per-slice partial groups merge at the root
        FINAL agg, which is also vectorized."""
        from ..distsql.copr import partial_agg_chunk
        limit = max(self.ctx.max_chunk_size, 4096)
        scan_fts = [c.ret_type for c in self.scan.schema.columns]
        while True:
            if self._replica is not None:
                raw = self._next_fast_raw()
                if raw is None:
                    return None
            else:
                if self._iter is None:
                    return None
                raw = Chunk(scan_fts, cap=limit)
                if self._fill_from_iter(raw, limit) == 0:
                    self._iter = None
                    return None
            if self.scan.filters:
                mask = self._filter_mask(raw, self.scan.filters)
                raw.set_sel(np.nonzero(mask)[0])
                raw = raw.compact()
            out = partial_agg_chunk(self.scan.pushed_agg, raw,
                                    self.field_types())
            if out is None or out.num_rows() == 0:
                continue
            return out

    def _handle_range_positions(self, rep) -> np.ndarray:
        """Replica row positions whose handle falls in the scan's
        [lo, hi] handle ranges (inclusive, like _iter_ranges).  Sorted
        handle arrays (the bulk-load/hydrate norm) binary-search; the
        general case falls back to boolean masking."""
        handles = rep.handles
        sorted_ = rep.memo(("handles_sorted",),
                           lambda: bool(len(handles) < 2
                                        or np.all(np.diff(handles) > 0)))
        parts = []
        for lo, hi in self.scan.ranges:
            if sorted_:
                a = int(np.searchsorted(handles, lo, side="left"))
                b = int(np.searchsorted(handles, hi, side="right"))
                parts.append(np.arange(a, b, dtype=np.int64))
            else:
                parts.append(np.nonzero((handles >= lo)
                                        & (handles <= hi))[0])
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(parts)

    def take_raw_replica(self):
        """Hand the WHOLE replica to the caller as a zero-copy chunk view
        plus this scan's filters and the replica object (for device-side
        memoization), consuming the reader (fused device pipelines own the
        replica contract through this single method).
        Returns (chunk, filters, replica) or (None, None, None)."""
        rep = self._replica
        if rep is None or self.scan.pushed_agg is not None \
                or self._range_sel is not None:
            return None, None, None
        from ..chunk import Column as CCol
        cols = []
        for c, ci in zip(self.scan.schema.columns, self._decode_cols):
            if ci is None:
                cols.append(CCol.wrap_raw(c.ret_type, rep.handles))
            else:
                v, m = rep.columns[ci.id]
                cols.append(CCol.wrap_raw(c.ret_type, v, m))
        self._replica = None  # consumed: this reader must not re-serve
        return Chunk.from_columns(cols), list(self.scan.filters), rep

    def _next_fast_raw(self) -> Optional[Chunk]:
        """Next unfiltered slice of the columnar replica.  The slice is
        capped by tidb_max_chunk_size: drain-block boundaries are where
        statement kill / deadline checks land and where processlist
        observes progress, so one monolithic slice would make a large
        scan uninterruptible and invisible."""
        rep = self._replica
        sel = self._range_sel
        n_total = len(sel) if sel is not None else rep.n_rows
        if self._pos >= n_total:
            self._slice_range = None
            return None
        step = min(self.FAST_CHUNK, max(self.ctx.max_chunk_size, 1))
        lo, hi = self._pos, min(self._pos + step, n_total)
        self._pos = hi
        from ..chunk import Column as CCol
        cols = []
        if sel is not None:
            # ranged serve: gather the in-range rows (fancy-index copy —
            # pk ranges are small); string-code fast filters don't apply
            # (_slice_range stays None -> vectorized_filter)
            self._slice_range = None
            idx = sel[lo:hi]
            for c, ci in zip(self.scan.schema.columns, self._decode_cols):
                if ci is None:
                    cols.append(CCol.wrap_raw(c.ret_type,
                                              rep.handles[idx]))
                else:
                    v, m = rep.columns[ci.id]
                    cols.append(CCol.wrap_raw(c.ret_type, v[idx], m[idx]))
            return Chunk.from_columns(cols)
        self._slice_range = (lo, hi)
        for c, ci in zip(self.scan.schema.columns, self._decode_cols):
            if ci is None:
                cols.append(CCol.wrap_raw(c.ret_type, rep.handles[lo:hi]))
            else:
                v, m = rep.columns[ci.id]
                # zero-copy views: keeps <U string dtype so filters
                # compare in C (from_numpy would object-convert per batch)
                cols.append(CCol.wrap_raw(c.ret_type, v[lo:hi], m[lo:hi]))
        return Chunk.from_columns(cols)

    def _fill_from_iter(self, chk: Chunk, limit: int) -> int:
        """Drain up to `limit` (handle, row) pairs from the scan iterator
        into `chk`, interleaving the handle into its schema slots."""
        n = 0
        for handle, row in self._iter:
            vals = []
            it = iter(row)
            for ci in self._decode_cols:
                vals.append(handle if ci is None else next(it))
            chk.append_row(vals)
            if self._hydrate is not None:
                self._hydrate["handles"].append(handle)
                self._hydrate["rows"].append(row)
            n += 1
            if n >= limit:
                break
        return n

    def _next_scan(self) -> Optional[Chunk]:
        if self._iter is None:
            return None
        limit = self.ctx.max_chunk_size
        chk = Chunk(self.field_types(), cap=limit)
        if self._fill_from_iter(chk, limit) == 0:
            self._iter = None
            self._finish_hydrate()
            return None
        return self._apply_filters(chk)

    def _apply_filters(self, chk: Chunk) -> Chunk:
        if self.scan.filters:
            mask = self._filter_mask(chk, self.scan.filters)
            chk.set_sel(np.nonzero(mask)[0])
            chk = chk.compact()
        return chk

    def _filter_mask(self, chk: Chunk, conds) -> np.ndarray:
        """Filter mask over a replica slice or plain chunk.  On the
        replica path, `string Column <op> string Constant` conditions run
        as int compares over the replica's memoized dictionary codes
        (order-preserving; the SAME memo the TPU tier's _code_cmp uses) —
        the CPU analogue of the reference's storage-side selection."""
        rng = getattr(self, "_slice_range", None)
        rep = self._replica
        if rep is None or rng is None:
            return vectorized_filter(conds, chk)
        from .gpu_executors import (_code_cmp, _parse_string_cmp, _slot_id,
                                    rep_string_codes)
        lo_r, hi_r = rng
        mask = None
        residual = []
        for cond in conds:
            sc = _parse_string_cmp(chk, cond)
            if sc is None:
                residual.append(cond)
                continue
            col, op, val = sc
            sid = _slot_id(self, col.index)
            v, nl = rep.columns[sid]
            codes, card, _, uniques = rep_string_codes(rep, sid, v, nl)
            klo = int(np.searchsorted(uniques, val, side="left"))
            khi = int(np.searchsorted(uniques, val, side="right"))
            m = _code_cmp(op, codes[lo_r:hi_r], klo, khi, card)
            mask = m if mask is None else (mask & m)
        if residual:
            m = vectorized_filter(residual, chk)
            mask = m if mask is None else (mask & m)
        return mask

    def _finish_hydrate(self) -> None:
        """A completed full scan hydrates the columnar replica so the next
        analytical query skips row decode entirely."""
        h = self._hydrate
        self._hydrate = None
        if h is None:
            return
        from ..columnar.store import hydrate_from_scan
        handles = np.asarray(h["handles"], dtype=np.int64)
        arrays = {}
        for j, ci in enumerate(self._real_cols):
            vals = [r[j] for r in h["rows"]]
            null = np.array([v is None for v in vals], dtype=bool)
            et = ci.ft.eval_type
            if et is EvalType.STRING:
                arr = np.array(["" if v is None else v for v in vals],
                               dtype=str)  # fixed-width <U: C-speed filters
            else:
                dt = np.int64 if et is EvalType.INT else np.float64
                if et is EvalType.INT:
                    # unsigned values wrap two's-complement into the int64
                    # buffer, same as Column.append
                    vals = [0 if v is None else
                            (v - (1 << 64) if v >= (1 << 63) else v)
                            for v in vals]
                else:
                    vals = [0 if v is None else v for v in vals]
                arr = np.array(vals, dtype=dt)
            arrays[ci.id] = (arr, null)
        hydrate_from_scan(self.ctx.storage, self.ctx.txn,
                          self.scan.table_info, [c.id for c in self._real_cols],
                          arrays, handles)

    def close(self) -> None:
        self._iter = None
        self._cop = None
        self._cop_rest = None
        self._hydrate = None
        super().close()


def _iter_index_entries(txn, iscan):
    """Yield (index_values, handle) over the scan's ranges in index order
    (reference: tables/index.go Seek + distsql index-range reads)."""
    from ..codec import keycodec, tablecodec
    from ..planner.ranger import MAX, MIN
    info = iscan.table_info
    idx = iscan.index
    prefix = tablecodec.encode_index_prefix(info.id, idx.id)
    uns = []
    for ic in idx.columns:
        ci = info.find_column(ic.name)
        uns.append(bool(ci is not None and ci.ft.is_unsigned))
    n_cols = len(idx.columns)

    def enc(vals):
        return keycodec.encode_key(list(vals), uns[:len(vals)])

    for r in iscan.ranges:
        low = list(r.low)
        if low and low[-1] is MIN:
            # open lower bound from a comparison: NULL never satisfies it,
            # and NULL sorts first — start just past the null point
            lo_key = prefix + enc(low[:-1]) + bytes([keycodec.NIL_FLAG + 1])
        elif low:
            lo_key = prefix + enc(low) + (b"" if r.low_incl else b"\xff")
        else:
            lo_key = prefix
        high = list(r.high)
        if high and high[-1] is MAX:
            hi_key = prefix + enc(high[:-1]) + b"\xff"
        elif high:
            hi_key = prefix + enc(high) + (b"\xff" if r.high_incl else b"")
        else:
            hi_key = prefix + b"\xff"
        for k, v in txn.iter_range(lo_key, hi_key):
            vals = keycodec.decode_key(k[len(prefix):])
            if len(vals) > n_cols:  # handle rides in the key (non-unique
                handle = int(vals[n_cols])  # or unique-with-nulls)
                vals = vals[:n_cols]
            else:
                handle = int(v)  # unique index: handle in the value
            yield vals, handle


class IndexReaderExec(Executor):
    """Covering index scan: answers straight from index entries
    (reference: executor/distsql.go IndexReaderExecutor :166)."""

    def __init__(self, plan):
        super().__init__(plan.schema, [])
        self.iscan = plan.scan

    def open(self, ctx):
        super().open(ctx)
        self._iter = _iter_index_entries(ctx.txn, self.iscan)

    def next(self) -> Optional[Chunk]:
        if self._iter is None:
            return None
        limit = self.ctx.max_chunk_size
        chk = Chunk(self.field_types(), cap=limit)
        n = 0
        for vals, handle in self._iter:
            row = []
            for src in self.iscan.output_sources:
                row.append(handle if src[0] == "handle" else vals[src[1]])
            chk.append_row(row)
            n += 1
            if n >= limit:
                break
        if n == 0:
            self._iter = None
            return None
        if self.iscan.filters:
            mask = vectorized_filter(self.iscan.filters, chk)
            chk.set_sel(np.nonzero(mask)[0])
            chk = chk.compact()
        return chk

    def close(self) -> None:
        self._iter = None
        super().close()


class IndexLookUpExec(Executor):
    """Double read: stage 1 walks the index collecting handles, stage 2
    fetches rows by handle with `tidb_index_lookup_concurrency` workers,
    preserving index order (reference: IndexLookUpExecutor's index worker ->
    table workers pipeline, executor/distsql.go:237-370)."""

    def __init__(self, plan):
        super().__init__(plan.schema, [])
        self.iscan = plan.index_scan
        self.tscan = plan.table_scan

    def open(self, ctx):
        super().open(ctx)
        info = self.tscan.table_info
        self._tbl = Table(info)
        self._decode_cols = []
        for c in self.tscan.schema.columns:
            if c.name == HANDLE_COL_NAME:
                self._decode_cols.append(None)
            else:
                self._decode_cols.append(info.find_column(c.name))
        self._real_cols = [ci for ci in self._decode_cols if ci is not None]
        self._entries = _iter_index_entries(ctx.txn, self.iscan)
        self._pool = None

    def _fetch_batch(self, handles):
        """Stage 2: point-read `handles` concurrently, results in index
        order (reference table workers; 4 by default).  Row keys are
        batch-encoded (native memcomparable codec when available)."""
        from ..codec import tablecodec
        txn = self.ctx.txn
        workers = int(self.ctx.session_vars.get(
            "tidb_index_lookup_concurrency", 4))
        rows: List[Optional[list]] = [None] * len(handles)
        keys = tablecodec.encode_row_keys_batch(
            self.tscan.table_info.id, handles)

        def fetch(span):
            for j in range(*span):
                v = txn.get(keys[j])
                rows[j] = self._tbl.decode_row(v, handles[j],
                                               self._real_cols)
        if workers <= 1 or len(handles) < 64:
            fetch((0, len(handles)))
        else:
            if self._pool is None:
                import concurrent.futures as cf
                self._pool = cf.ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="kv-lookup")
            step = (len(handles) + workers - 1) // workers
            spans = [(i, min(i + step, len(handles)))
                     for i in range(0, len(handles), step)]
            list(self._pool.map(fetch, spans))
        return rows

    def next(self) -> Optional[Chunk]:
        if self._entries is None:
            return None
        limit = self.ctx.max_chunk_size
        handles = []
        for _, handle in self._entries:
            handles.append(handle)
            if len(handles) >= limit:
                break
        if not handles:
            self._entries = None
            return None
        rows = self._fetch_batch(handles)
        chk = Chunk(self.field_types(), cap=len(handles))
        for h, row in zip(handles, rows):
            vals = []
            it = iter(row)
            for ci in self._decode_cols:
                vals.append(h if ci is None else next(it))
            chk.append_row(vals)
        if self.tscan.filters:
            mask = vectorized_filter(self.tscan.filters, chk)
            chk.set_sel(np.nonzero(mask)[0])
            chk = chk.compact()
        return chk

    def close(self) -> None:
        self._entries = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        super().close()


class MemTableExec(Executor):
    """INFORMATION_SCHEMA virtual tables computed from the live schema
    (reference: infoschema/tables.go)."""

    def __init__(self, plan):
        super().__init__(plan.schema, [])
        self.table = plan.table
        self._done = False

    def open(self, ctx):
        super().open(ctx)
        self._done = False

    def next(self) -> Optional[Chunk]:
        if self._done:
            return None
        self._done = True
        from ..catalog.memtables import memtable_rows
        rows = memtable_rows(self.ctx.infoschema, self.table)
        chk = Chunk(self.field_types(), cap=max(len(rows), 1))
        for r in rows:
            chk.append_row(r)
        return chk


class SelectionExec(Executor):
    """Vectorized filter with sel-vector semantics (reference:
    executor.go:346-420; the course's stub :396)."""

    def __init__(self, plan: PhysicalSelection, child: Executor):
        super().__init__(plan.schema, [child])
        self.conditions = plan.conditions

    def next(self) -> Optional[Chunk]:
        while True:
            chk = self.children[0].next()
            if chk is None:
                return None
            chk = chk.compact()
            mask = vectorized_filter(self.conditions, chk)
            if not mask.any():
                continue
            chk.set_sel(np.nonzero(mask)[0])
            return chk.compact()


class ProjectionExec(Executor):
    """Vectorized projection (reference: projection.go — vectorized by
    construction here; the goroutine pipeline maps to device parallelism)."""

    def __init__(self, plan: PhysicalProjection, child: Executor):
        super().__init__(plan.schema, [child])
        self.exprs = plan.exprs

    def next(self) -> Optional[Chunk]:
        chk = self.children[0].next()
        if chk is None:
            return None
        chk = chk.compact()
        from ..chunk import Column as CCol
        cols = []
        for e, out_c in zip(self.exprs, self.schema.columns):
            v, null = e.vec_eval(chk)
            cols.append(CCol.from_numpy(out_c.ret_type, v, null))
        return Chunk.from_columns(cols) if cols else chk


class HashAggExec(Executor):
    """Hash aggregation (reference: aggregate.go two-stage parallel hash agg;
    single-threaded CPU tier here — the parallel partial/final split runs on
    the TPU/distributed tier via the same AggState partial protocol)."""

    def __init__(self, plan: PhysicalHashAgg, child: Executor):
        super().__init__(plan.schema, [child])
        self.plan = plan
        self._done = False

    def open(self, ctx):
        super().open(ctx)
        self._done = False

    def _vec_gate(self) -> bool:
        """All-numpy aggregation path: COMPLETE-mode, non-distinct
        count/sum/avg/min/max/first_row.  Accumulation order matches the
        row loop bit-for-bit (bincount adds in row order), so results are
        identical, just without the per-row Python."""
        from ..expression.aggregation import (AGG_AVG, AGG_COUNT,
                                              AGG_FIRST_ROW, AGG_MAX,
                                              AGG_MIN, AGG_SUM)
        ok = {AGG_COUNT, AGG_SUM, AGG_AVG, AGG_MIN, AGG_MAX, AGG_FIRST_ROW}
        for d in self.plan.aggs:
            # FINAL merges are vectorizable too: count/sum merge = add,
            # avg merges (sum, count) partial columns, min/max/first_row
            # merge = update
            if d.distinct:
                return False
            if d.name not in ok:
                return False
            if d.name in (AGG_MIN, AGG_MAX):
                a = d.args[0]
                # string / wrapped-unsigned compare orders need the
                # row-path semantics
                if a.eval_type is EvalType.STRING or _uns_of(a):
                    return False
        return True

    def _vec_agg(self) -> Optional[Chunk]:
        from ..chunk import Column as CCol
        from ..expression.aggregation import (AGG_AVG, AGG_COUNT,
                                              AGG_FIRST_ROW, AGG_MAX,
                                              AGG_MIN, AGG_SUM)
        plan = self.plan
        child = self.children[0]
        chunks = []
        while True:
            interrupt.check()
            chk = child.next()
            if chk is None:
                break
            chk = chk.compact()
            if chk.num_rows():
                chunks.append(chk)
        total = sum(c.num_rows() for c in chunks)
        if total == 0:
            if plan.group_by:
                return None
            # COUNT()=0 / SUM()=NULL single row over empty input
            states = [new_state(d) for d in plan.aggs]
            out = Chunk(self.field_types(), cap=1)
            out.append_row([states[i].result() if src == "agg" else None
                            for src, i in plan.output_map])
            return out

        def cat(expr):
            vs, ns = [], []
            for c in chunks:
                v, nl = expr.vec_eval(c)
                vs.append(np.asarray(v))
                ns.append(np.asarray(nl))
            return np.concatenate(vs), np.concatenate(ns)

        # ---- group ids: factorize each key column, combine, relabel in
        # first-occurrence order (matches the dict path's insertion order)
        kdata = [cat(e) for e in plan.group_by]
        gid = np.zeros(total, dtype=np.int64)
        for v, nl in kdata:
            if v.dtype == object or v.dtype.kind == "U":
                sv = np.where(nl, "", v).astype(str)
            else:
                sv = np.where(nl, v[0], v)
            _, inv = np.unique(sv, return_inverse=True)
            inv = inv.astype(np.int64)
            card = int(inv.max()) + 1
            code = np.where(nl, card, inv)
            _, gid = np.unique(gid * (card + 1) + code,
                               return_inverse=True)
            gid = gid.astype(np.int64)
        ug, first_idx, inv2 = np.unique(gid, return_index=True,
                                        return_inverse=True)
        order = np.argsort(first_idx, kind="stable")
        relabel = np.empty(len(ug), dtype=np.int64)
        relabel[order] = np.arange(len(ug), dtype=np.int64)
        gid = relabel[inv2.astype(np.int64)]
        first_idx = first_idx[order]
        ng = len(ug)

        def to_real(v, uns):
            fv = v.astype(np.float64)
            if uns and v.dtype == np.int64:
                fv = np.where(v < 0, fv + 2.0**64, fv)
            return fv

        from ..expression.aggregation import AggMode
        out_aggs = []
        for d in plan.aggs:
            name = d.name
            final = d.mode is AggMode.FINAL
            if name == AGG_COUNT:
                if final:
                    # merge: sum the partial counts (None partials skip)
                    v, nl = cat(d.args[0])
                    m = ~nl
                    acc = np.zeros(ng, dtype=np.int64)
                    np.add.at(acc, gid[m], v[m].astype(np.int64))
                    out_aggs.append((acc, np.zeros(ng, dtype=bool)))
                    continue
                m = np.ones(total, dtype=bool)
                for a in d.args:
                    _, nl = cat(a)
                    m &= ~nl
                cnt = np.bincount(gid[m], minlength=ng).astype(np.int64)
                out_aggs.append((cnt, np.zeros(ng, dtype=bool)))
            elif name == AGG_AVG and final:
                # FINAL avg over (sum, count) partial columns
                sm, snl = cat(d.args[0])
                cn, cnl = cat(d.args[1])
                m = ~cnl & (cn != 0)
                n_acc = np.zeros(ng, dtype=np.int64)
                np.add.at(n_acc, gid[m], cn[m].astype(np.int64))
                w = np.where(snl, 0.0, to_real(sm, False))
                s = np.bincount(gid[m], weights=w[m], minlength=ng)
                out_aggs.append((s / np.maximum(n_acc, 1), n_acc == 0))
            elif name in (AGG_SUM, AGG_AVG):
                # sum merge (FINAL) = sum update: one shared path
                a = d.args[0]
                v, nl = cat(a)
                m = ~nl
                cnt = np.bincount(gid[m], minlength=ng).astype(np.int64)
                if name == AGG_SUM \
                        and d.ret_type.eval_type is EvalType.INT:
                    acc = np.zeros(ng, dtype=np.int64)
                    np.add.at(acc, gid[m], v[m].astype(np.int64))
                    out_aggs.append((acc, cnt == 0))
                else:
                    s = np.bincount(gid[m], weights=to_real(v, _uns_of(a))[m],
                                    minlength=ng)
                    if name == AGG_AVG:
                        s = s / np.maximum(cnt, 1)
                    out_aggs.append((s, cnt == 0))
            elif name in (AGG_MIN, AGG_MAX):
                a = d.args[0]
                v, nl = cat(a)
                m = ~nl
                g2, v2 = gid[m], v[m]
                res = np.zeros(ng, dtype=v.dtype)
                rnull = np.ones(ng, dtype=bool)
                if len(g2):
                    o = np.argsort(g2, kind="stable")
                    g2s, v2s = g2[o], v2[o]
                    starts = np.nonzero(
                        np.r_[True, g2s[1:] != g2s[:-1]])[0]
                    red = (np.maximum if name == AGG_MAX
                           else np.minimum).reduceat(v2s, starts)
                    present = g2s[starts]
                    res[present] = red
                    rnull[present] = False
                out_aggs.append((res, rnull))
            else:  # AGG_FIRST_ROW
                v, nl = cat(d.args[0])
                out_aggs.append((v[first_idx], nl[first_idx]))

        out_cols = []
        for (src, idx), oc in zip(plan.output_map, self.schema.columns):
            if src == "agg":
                v, nl = out_aggs[idx]
            else:
                v, nl = kdata[idx][0][first_idx], kdata[idx][1][first_idx]
            out_cols.append(CCol.from_numpy(oc.ret_type, v, nl))
        return Chunk.from_columns(out_cols)

    def next(self) -> Optional[Chunk]:
        if self._done:
            return None
        self._done = True
        plan = self.plan
        if self._vec_gate():
            return self._vec_agg()
        groups: Dict[tuple, list] = {}
        gb_vals: Dict[tuple, list] = {}
        child = self.children[0]
        while True:
            interrupt.check()
            chk = child.next()
            if chk is None:
                break
            chk = chk.compact()
            n = chk.num_rows()
            # vectorized group key computation (unsigned ints live wrapped
            # in the int64 buffers — unwrap to semantic python values here)
            key_cols = [(*e.vec_eval(chk), _uns_of(e))
                        for e in plan.group_by]
            # agg arg values, vectorized
            arg_cols = []
            for d in plan.aggs:
                arg_cols.append([(*a.vec_eval(chk), _uns_of(a))
                                 for a in d.args])
            for i in range(n):
                key = tuple(_semantic(v, null, i, u)
                            for v, null, u in key_cols)
                st = groups.get(key)
                if st is None:
                    st = groups[key] = [new_state(d) for d in plan.aggs]
                    gb_vals[key] = list(key)
                for d_idx, d in enumerate(plan.aggs):
                    vals = [_semantic(v, null, i, u)
                            for v, null, u in arg_cols[d_idx]]
                    st[d_idx].update(vals)
        if not groups and not plan.group_by:
            # empty input, no GROUP BY: one row (COUNT()=0, SUM()=NULL)
            groups[()] = [new_state(d) for d in plan.aggs]
            gb_vals[()] = []
        out = Chunk(self.field_types(), cap=max(len(groups), 1))
        for key, states in groups.items():
            row = []
            for src, idx in plan.output_map:
                if src == "agg":
                    row.append(states[idx].result())
                else:
                    row.append(gb_vals[key][idx])
            out.append_row(row)
        return out if out.num_rows() else None


class HashJoinExec(Executor):
    """Hash join: build + probe (reference: join.go:31-350, course stubs
    :149/:244 implemented).  Build side = right child."""

    def __init__(self, plan: PhysicalHashJoin, left: Executor, right: Executor):
        super().__init__(plan.schema, [left, right])
        self.plan = plan
        self._built = False

    def open(self, ctx):
        super().open(ctx)
        self._built = False
        self._probe_buf = None

    def _native_fast_ok(self) -> bool:
        """Single int64 equi-key with matching signedness: the native
        open-addressing table (util/mvmap analogue) builds and probes on
        raw key buffers."""
        plan = self.plan
        if len(plan.left_keys) != 1:
            return False
        lk, rk = plan.left_keys[0], plan.right_keys[0]
        if lk.eval_type is not EvalType.INT or rk.eval_type is not EvalType.INT:
            return False
        return _uns_of(lk) == _uns_of(rk)

    def _build(self) -> None:
        from .. import native
        plan = self.plan
        build = self.children[1]
        self._build_rows: List[list] = []
        self._table: Dict[tuple, List[int]] = {}
        self._ht = None
        self._build_chunk: Optional[Chunk] = None
        use_native = self._native_fast_ok() and native.lib() is not None
        # fully-columnar path: native table + no per-row residual conds
        # means build AND probe stay vectorized end to end
        self._vec_ok = use_native and not plan.other_conditions \
            and plan.tp not in ("semi", "anti")
        if self._vec_ok:
            self._build_chunk = Chunk(
                [c.ret_type for c in self.children[1].schema.columns])
        # NOT IN null semantics need the build side's shape beyond the
        # hash table: total live rows (NULL keys included) and whether
        # any live row carried a NULL key
        self._build_n_live = 0
        self._build_has_null_key = False
        nat_keys: List[np.ndarray] = []
        while True:
            interrupt.check()
            chk = build.next()
            if chk is None:
                break
            chk = chk.compact()
            if plan.right_conditions:
                mask = vectorized_filter(plan.right_conditions, chk)
                chk.set_sel(np.nonzero(mask)[0])
                chk = chk.compact()
            self._build_n_live += chk.num_rows()
            if use_native:
                v, null = plan.right_keys[0].vec_eval(chk)
                self._build_has_null_key |= bool(np.asarray(null).any())
                keep = np.nonzero(~null)[0]  # NULL keys never equi-match
                nat_keys.append(np.asarray(v, dtype=np.int64)[keep])
                if self._vec_ok:
                    for dst, src in zip(self._build_chunk.columns,
                                        chk.columns):
                        dst.extend_take(src, keep)
                elif plan.tp in ("semi", "anti") \
                        and not plan.other_conditions:
                    pass  # membership probe reads only the hash table
                else:
                    for i in keep:
                        self._build_rows.append(chk.get_row(int(i)))
                continue
            keys = [(*e.vec_eval(chk), _uns_of(e)) for e in plan.right_keys]
            for i in range(chk.num_rows()):
                row = chk.get_row(i)
                key = tuple(_semantic(v, null, i, u) for v, null, u in keys)
                if any(k is None for k in key):
                    self._build_has_null_key = True
                    continue  # NULL never equi-matches
                idx = len(self._build_rows)
                self._build_rows.append(row)
                self._table.setdefault(key, []).append(idx)
        if use_native:
            bk = (np.concatenate(nat_keys) if nat_keys
                  else np.empty(0, dtype=np.int64))
            self._ht = native.I64HashTable(bk)
        self._n_right = len(self.children[1].schema.columns)
        self._built = True

    def next(self) -> Optional[Chunk]:
        if not self._built:
            self._build()
        plan = self.plan
        left = self.children[0]
        if plan.tp in ("semi", "anti"):
            return self._next_semi(left, plan)
        if self._ht is not None and self._vec_ok:
            return self._next_vec(left, plan)
        out_limit = self.ctx.max_chunk_size
        out = Chunk(self.field_types(), cap=out_limit)
        while True:
            chk = left.next()
            if chk is None:
                break
            chk = chk.compact()
            lmask = None
            if plan.left_conditions:
                mask = vectorized_filter(plan.left_conditions, chk)
                if plan.tp == "left":
                    # outer join: ON-clause left conds decide matching —
                    # a failing outer row null-extends instead of dropping
                    lmask = mask
                else:
                    chk.set_sel(np.nonzero(mask)[0])
                    chk = chk.compact()
            if self._ht is not None:
                v, null = plan.left_keys[0].vec_eval(chk)
                ids, counts = self._ht.probe(
                    np.asarray(v, dtype=np.int64), ~null)
                offsets = np.concatenate(([0], np.cumsum(counts)))
            else:
                keys = [(*e.vec_eval(chk), _uns_of(e))
                        for e in plan.left_keys]
            for i in range(chk.num_rows()):
                lrow = chk.get_row(i)
                if lmask is not None and not lmask[i]:
                    out.append_row(lrow + [None] * self._n_right)
                    continue
                if self._ht is not None:
                    matches = ids[offsets[i]:offsets[i + 1]]
                else:
                    key = tuple(_semantic(v, null, i, u)
                                for v, null, u in keys)
                    matches = [] if any(k is None for k in key) \
                        else self._table.get(key, [])
                matched = False
                for bi in matches:
                    joined = lrow + self._build_rows[bi]
                    if plan.other_conditions and not self._others_ok(joined):
                        continue
                    matched = True
                    out.append_row(joined)
                if not matched and plan.tp == "left":
                    out.append_row(lrow + [None] * self._n_right)
            if out.num_rows() >= out_limit:
                return out
        return out if out.num_rows() else None

    def _next_semi(self, left, plan) -> Optional[Chunk]:
        """Semi / anti join probe: emit LEFT rows only.  Covers keyed
        membership (IN / correlated EXISTS), the cartesian degenerate
        (uncorrelated EXISTS: any live build row matches every probe
        row), residual other_conditions (correlated non-equi), and the
        NULL-aware NOT IN ladder:

        - empty build side  -> anti keeps EVERY probe row (NULL too)
        - any NULL build key (null_aware) -> anti keeps NOTHING
        - NULL probe key (null_aware) -> dropped; plain anti keeps it
        """
        anti = plan.tp == "anti"
        na = anti and getattr(plan, "null_aware", False)
        out_limit = self.ctx.max_chunk_size
        out = Chunk(self.field_types(), cap=out_limit)
        while True:
            interrupt.check()
            chk = left.next()
            if chk is None:
                break
            chk = chk.compact()
            if plan.left_conditions:
                mask = vectorized_filter(plan.left_conditions, chk)
                chk.set_sel(np.nonzero(mask)[0])
                chk = chk.compact()
            n = chk.num_rows()
            if n == 0:
                continue
            if self._build_n_live == 0:
                if anti:  # NOT IN () / NOT EXISTS over empty: all pass
                    return chk
                continue
            if na and self._build_has_null_key:
                continue  # x NOT IN (..., NULL, ...) is never TRUE
            if self._ht is not None and not plan.other_conditions:
                # fully-columnar membership: probe counts -> boolean
                # keep -> one selection compact, no per-row marshalling
                v, null = plan.left_keys[0].vec_eval(chk)
                null = np.asarray(null)
                _ids, counts = self._ht.probe(
                    np.asarray(v, dtype=np.int64), ~null)
                matched = np.asarray(counts) > 0
                if anti:
                    keep = ~matched & (~null if na else
                                       np.ones(n, dtype=bool))
                else:
                    keep = matched
                sel = np.nonzero(keep)[0]
                if len(sel) == 0:
                    continue
                chk.set_sel(sel)
                return chk.compact()
            else:
                if self._ht is not None:
                    v, null = plan.left_keys[0].vec_eval(chk)
                    ids, counts = self._ht.probe(
                        np.asarray(v, dtype=np.int64), ~null)
                    offsets = np.concatenate(([0], np.cumsum(counts)))
                    nulls = np.asarray(null)
                else:
                    keys = [(*e.vec_eval(chk), _uns_of(e))
                            for e in plan.left_keys]
                for i in range(n):
                    lrow = chk.get_row(i)
                    if self._ht is not None:
                        probe_null = bool(nulls[i])
                        matches = ids[offsets[i]:offsets[i + 1]]
                    else:
                        key = tuple(_semantic(v, null, i, u)
                                    for v, null, u in keys)
                        probe_null = any(k is None for k in key)
                        matches = [] if probe_null \
                            else self._table.get(key, [])
                    hit = False
                    for bi in matches:
                        if plan.other_conditions and not self._others_ok(
                                lrow + self._build_rows[bi]):
                            continue
                        hit = True
                        break
                    if na and probe_null:
                        continue  # NULL NOT IN (non-empty) is NULL
                    if hit != anti:
                        out.append_row(lrow)
            if out.num_rows() >= out_limit:
                return out
        return out if out.num_rows() else None

    def _next_vec(self, left, plan) -> Optional[Chunk]:
        """Fully vectorized probe (the hot path the reference runs in its
        probe workers, join.go:325): native hash probe gives per-row match
        ids/counts; the joined chunk assembles by columnar fancy-indexing
        — np.repeat(probe) x gather(build) — with LEFT-join null extension
        appended as a block.  No per-row Python."""
        from ..chunk import Column as CCol
        fields = self.field_types()
        bcols = self._build_chunk.columns
        outer = plan.tp == "left"
        while True:
            chk = left.next()
            if chk is None:
                return None
            chk = chk.compact()
            n = chk.num_rows()
            if n == 0:
                continue
            lmask = None
            if plan.left_conditions:
                mask = vectorized_filter(plan.left_conditions, chk)
                if outer:
                    # ON-clause left conds decide matching — a failing
                    # outer row null-extends instead of dropping
                    lmask = mask
                else:
                    chk.set_sel(np.nonzero(mask)[0])
                    chk = chk.compact()
                    n = chk.num_rows()
                    if n == 0:
                        continue
            v, null = plan.left_keys[0].vec_eval(chk)
            ids, counts = self._ht.probe(np.asarray(v, dtype=np.int64),
                                         ~null)
            ids = np.asarray(ids, dtype=np.int64)
            counts = np.asarray(counts, dtype=np.int64)
            if lmask is not None:
                ids = ids[np.repeat(lmask, counts)]
                counts = np.where(lmask, counts, 0)
            pidx = np.repeat(np.arange(n, dtype=np.int64), counts)
            un = np.nonzero(counts == 0)[0] if outer \
                else np.empty(0, dtype=np.int64)
            n_un = len(un)
            if len(pidx) == 0 and n_un == 0:
                continue
            pairs = []
            for c in chk.columns:
                vv, mm = c.values(), c.null_mask()
                if n_un:
                    pairs.append((np.concatenate([vv[pidx], vv[un]]),
                                  np.concatenate([mm[pidx], mm[un]])))
                else:
                    pairs.append((vv[pidx], mm[pidx]))
            for c in bcols:
                vv, mm = c.values(), c.null_mask()
                va, ma = vv[ids], mm[ids]
                if n_un:
                    filler = (np.full(n_un, None, dtype=object)
                              if vv.dtype == object
                              else np.zeros(n_un, dtype=vv.dtype))
                    va = np.concatenate([va, filler])
                    ma = np.concatenate([ma, np.ones(n_un, dtype=bool)])
                pairs.append((va, ma))
            return Chunk.from_columns(
                [CCol.from_numpy(ft, va, ma)
                 for ft, (va, ma) in zip(fields, pairs)])

    def _others_ok(self, joined_row) -> bool:
        return _eval_other_conds(self.plan.other_conditions, joined_row)


def _uns_of(e) -> bool:
    """INT expression whose int64 buffer holds wrapped uint64 values."""
    return (e.eval_type is EvalType.INT
            and getattr(e.ret_type, "is_unsigned", False))


def _semantic(v, null, i: int, uns: bool):
    """Buffer cell -> semantic python value (unwraps wrapped unsigned)."""
    if null[i]:
        return None
    x = v[i].item() if hasattr(v[i], "item") else v[i]
    if uns and isinstance(x, int) and x < 0:
        x += 1 << 64
    return x


def _semantic_keys(expr, chk: Chunk) -> list:
    """Join-key column of `chk` as semantic python values (shared by the
    hash and merge join key paths)."""
    v, null = expr.vec_eval(chk)
    uns = _uns_of(expr)
    return [_semantic(v, null, i, uns) for i in range(chk.num_rows())]


def _eval_other_conds(conds, joined_row) -> bool:
    from ..expression import eval_bool_scalar
    return eval_bool_scalar(conds, joined_row)


class _RowCursor:
    """Row-at-a-time cursor over an executor's chunk stream, exposing the
    join key's semantic value per row; `side_conds` filter each chunk
    before it is exposed (the join's one-side conditions)."""

    def __init__(self, ex: Executor, key_expr, side_conds=None,
                 mask_mode: bool = False):
        self.ex = ex
        self.key_expr = key_expr
        self.side_conds = side_conds or []
        # mask_mode (outer side of an outer join): failing rows stay in the
        # stream with passes()==False so the join can null-extend them
        self.mask_mode = mask_mode
        self._chk = None
        self._keys = None
        self._mask = None
        self._i = 0
        self.done = False
        self._advance_chunk()

    def _advance_chunk(self) -> None:
        while True:
            chk = self.ex.next()
            if chk is None:
                self.done = True
                return
            chk = chk.compact()
            self._mask = None
            if self.side_conds and chk.num_rows():
                mask = vectorized_filter(self.side_conds, chk)
                if self.mask_mode:
                    self._mask = mask
                else:
                    chk.set_sel(np.nonzero(mask)[0])
                    chk = chk.compact()
            if chk.num_rows() == 0:
                continue
            self._chk = chk
            self._keys = _semantic_keys(self.key_expr, chk)
            self._i = 0
            return

    def key(self):
        return self._keys[self._i]

    def passes(self) -> bool:
        return self._mask is None or bool(self._mask[self._i])

    def row(self):
        return self._chk.get_row(self._i)

    def advance(self) -> None:
        self._i += 1
        if self._i >= self._chk.num_rows():
            self._advance_chunk()


class MergeJoinExec(Executor):
    """Sorted-input merge join with inner-group buffering (reference:
    executor/merge_join.go:31 — both inputs arrive in join-key order; the
    planner only picks this operator for clustered-pk-ordered scans)."""

    def __init__(self, plan, left: Executor, right: Executor):
        super().__init__(plan.schema, [left, right])
        self.plan = plan

    def open(self, ctx):
        super().open(ctx)
        self._lcur = None
        self._done = False

    def _others_ok(self, joined_row) -> bool:
        return _eval_other_conds(self.plan.other_conditions, joined_row)

    def next(self) -> Optional[Chunk]:
        if self._done:
            return None
        plan = self.plan
        if self._lcur is None:
            self._lcur = _RowCursor(self.children[0], plan.left_keys[0],
                                    plan.left_conditions,
                                    mask_mode=(plan.tp == "left"))
            self._rcur = _RowCursor(self.children[1], plan.right_keys[0],
                                    plan.right_conditions)
            self._n_right = len(self.children[1].schema.columns)
            self._rgroup_key = object()
            self._rgroup: List[list] = []
        out_limit = self.ctx.max_chunk_size
        out = Chunk(self.field_types(), cap=out_limit)
        lcur, rcur = self._lcur, self._rcur
        while not lcur.done and out.num_rows() < out_limit:
            lk = lcur.key()
            if not lcur.passes():
                # ON-clause outer-side cond failed: null-extend (left join)
                out.append_row(lcur.row() + [None] * self._n_right)
                lcur.advance()
                continue
            if lk is None:  # NULL keys never equi-match
                if plan.tp == "left":
                    out.append_row(lcur.row() + [None] * self._n_right)
                lcur.advance()
                continue
            # advance the buffered right group to lk
            if self._rgroup_key != lk:
                while not rcur.done and _key_lt(rcur.key(), lk):
                    rcur.advance()
                self._rgroup = []
                self._rgroup_key = lk
                while not rcur.done and rcur.key() == lk:
                    self._rgroup.append(rcur.row())
                    rcur.advance()
            matched = False
            for rrow in self._rgroup:
                joined = lcur.row() + rrow
                if plan.other_conditions and not self._others_ok(joined):
                    continue
                matched = True
                out.append_row(joined)
            if not matched and plan.tp == "left":
                out.append_row(lcur.row() + [None] * self._n_right)
            lcur.advance()
        if out.num_rows() == 0:
            self._done = True
            return None
        return out


def _key_lt(a, b) -> bool:
    """NULL sorts first (mirrors the key codec's ordering)."""
    if a is None:
        return b is not None
    if b is None:
        return False
    return a < b


def _sort_keys_for_rows(by, chk: Chunk):
    """Compute (columns of total-order keys, descending flags)."""
    cols = []
    descs = []
    for e, desc in by:
        v, null = e.vec_eval(chk)
        cols.append((v, null))
        descs.append(desc)
    return cols, descs


class SortExec(Executor):
    """Full in-memory sort (reference: sort.go:27-146, row-pointer
    indirection == argsort over key arrays)."""

    def __init__(self, plan: PhysicalSort, child: Executor):
        super().__init__(plan.schema, [child])
        self.by = plan.by
        self._out = None

    def open(self, ctx):
        super().open(ctx)
        self._out = None

    def _materialize(self):
        child = self.children[0]
        all_chk = Chunk(self.field_types(), cap=MAX_CHUNK_SIZE)
        while True:
            interrupt.check()
            chk = child.next()
            if chk is None:
                break
            all_chk.append_chunk(chk)
        n = all_chk.num_rows()
        if n == 0:
            self._out = iter([])
            return
        order = _argsort_chunk(self.by, all_chk)
        all_chk.set_sel(order)
        self._out = iter([all_chk.compact()])

    def next(self) -> Optional[Chunk]:
        if self._out is None:
            self._materialize()
        return next(self._out, None)


def _argsort_chunk(by, chk: Chunk) -> np.ndarray:
    """Stable multi-key argsort with NULLs-first MySQL semantics; numeric
    keys sort via numpy lexsort, strings via Python key sort."""
    n = chk.num_rows()
    keys = []
    any_str = False
    for e, desc in by:
        v, null = e.vec_eval(chk)
        if v.dtype == object:
            any_str = True
        elif v.dtype == np.int64 and e.ret_type.is_unsigned:
            # unsigned columns live two's-complement-wrapped in the int64
            # buffer; reinterpret so 2^64-1 sorts above 0
            v = v.view(np.uint64)
        keys.append((v, null, desc))
    if not any_str:
        # MySQL semantics: NULL sorts lowest (first in ASC, last in DESC).
        # lexsort: LAST array is most significant -> emit per-key
        # (value, null_rank) pairs walking the sort keys in reverse.
        arrs = []
        for v, null, desc in reversed(keys):
            vv = np.where(null, 0, v)  # neutralize NULL slots
            if desc:
                with np.errstate(over="ignore"):
                    if vv.dtype == np.uint64:
                        vv = np.iinfo(np.uint64).max - vv  # order-reversing
                    elif vv.dtype == np.int64:
                        vv = ~vv  # overflow-free (-v overflows at int64 min)
                    else:
                        vv = -vv
                rank = np.where(null, 1, 0).astype(np.int8)  # NULL last
            else:
                rank = np.where(null, 0, 1).astype(np.int8)  # NULL first
            arrs.append(vv)
            arrs.append(rank)
        return np.lexsort(arrs)
    # string keys: python sort
    def row_key(i):
        out = []
        for v, null, desc in keys:
            if null[i]:
                k = (0 if not desc else 2, 0)
            else:
                val = v[i]
                val = val.item() if hasattr(val, "item") else val
                sk = sort_key(val)
                if desc:
                    k = (1, _Neg(sk))
                else:
                    k = (1, sk)
            out.append(k)
        return out
    return np.array(sorted(range(n), key=row_key), dtype=np.int64)


class _Neg:
    """Reverses comparison order of a wrapped key."""
    __slots__ = ("k",)

    def __init__(self, k):
        self.k = k

    def __lt__(self, other):
        return other.k < self.k

    def __eq__(self, other):
        return self.k == other.k


class TopNExec(Executor):
    """Top-k (reference: sort.go:148-318 TopNExec heap)."""

    def __init__(self, plan: PhysicalTopN, child: Executor):
        super().__init__(plan.schema, [child])
        self.by = plan.by
        self.offset = plan.offset
        self.count = plan.count
        self._out = None

    def open(self, ctx):
        super().open(ctx)
        self._out = None

    def next(self) -> Optional[Chunk]:
        if self._out is None:
            child = self.children[0]
            all_chk = Chunk(self.field_types(), cap=MAX_CHUNK_SIZE)
            while True:
                interrupt.check()
                chk = child.next()
                if chk is None:
                    break
                all_chk.append_chunk(chk)
                # bound the buffer: keep only the current top
                # offset+count rows when it grows too large
                if all_chk.num_rows() >= 4 * max(self.offset + self.count, 256):
                    order = _argsort_chunk(self.by, all_chk)
                    all_chk.set_sel(order[: self.offset + self.count])
                    all_chk = all_chk.compact()
            if all_chk.num_rows():
                order = _argsort_chunk(self.by, all_chk)
                sel = order[self.offset: self.offset + self.count]
                all_chk.set_sel(sel)
                self._out = iter([all_chk.compact()] if len(sel) else [])
            else:
                self._out = iter([])
        return next(self._out, None)


class LimitExec(Executor):
    def __init__(self, plan: PhysicalLimit, child: Executor):
        super().__init__(plan.schema, [child])
        self.offset = plan.offset
        self.count = plan.count

    def open(self, ctx):
        super().open(ctx)
        self._skipped = 0
        self._emitted = 0

    def next(self) -> Optional[Chunk]:
        while self._emitted < self.count:
            chk = self.children[0].next()
            if chk is None:
                return None
            chk = chk.compact()
            n = chk.num_rows()
            start = 0
            if self._skipped < self.offset:
                take_skip = min(self.offset - self._skipped, n)
                self._skipped += take_skip
                start = take_skip
            avail = n - start
            if avail <= 0:
                continue
            take = min(avail, self.count - self._emitted)
            self._emitted += take
            chk.set_sel(np.arange(start, start + take))
            return chk.compact()
        return None


class TableDualExec(Executor):
    def __init__(self, plan: PhysicalTableDual):
        super().__init__(plan.schema, [])
        self.row_count = plan.row_count
        self._done = False

    def open(self, ctx):
        super().open(ctx)
        self._done = False

    def next(self) -> Optional[Chunk]:
        if self._done:
            return None
        self._done = True
        chk = Chunk(self.field_types(), cap=max(self.row_count, 1))
        if not self.schema.columns:
            chk.virtual_rows = self.row_count
        else:
            for _ in range(self.row_count):
                chk.append_row([None] * len(self.schema.columns))
        return chk


def build_executor(plan: PhysicalPlan, use_tpu: bool = False) -> Executor:
    """Physical plan -> executor tree (reference: executor/builder.go:69-117).
    With use_tpu, the big four operators come from the TPU tier when the
    plan's device enforcer marked them eligible.  Every executor is
    tagged with the plan node it was built from (``_obs_plan``) so
    obs/runtime_stats can key per-operator RuntimeStats for
    EXPLAIN ANALYZE without per-executor changes."""
    ex = _build_executor(plan, use_tpu)
    if getattr(ex, "_obs_plan", None) is None:
        ex._obs_plan = plan
    return ex


def _build_executor(plan: PhysicalPlan, use_tpu: bool = False) -> Executor:
    if use_tpu and getattr(plan, "use_tpu", False):
        from .gpu_executors import build_gpu_executor
        ex = build_gpu_executor(plan)
        if ex is not None:
            return ex
    if isinstance(plan, PhysicalTableReader):
        return TableReaderExec(plan)
    if isinstance(plan, PhysicalIndexReader):
        return IndexReaderExec(plan)
    if isinstance(plan, PhysicalIndexLookUpReader):
        return IndexLookUpExec(plan)
    from ..planner.physical import PhysicalMemTable
    if isinstance(plan, PhysicalMemTable):
        return MemTableExec(plan)
    if isinstance(plan, PhysicalSelection):
        return SelectionExec(plan, build_executor(plan.children[0], use_tpu))
    if isinstance(plan, PhysicalProjection):
        return ProjectionExec(plan, build_executor(plan.children[0], use_tpu))
    if isinstance(plan, PhysicalHashAgg):
        return HashAggExec(plan, build_executor(plan.children[0], use_tpu))
    if isinstance(plan, PhysicalMergeJoin):
        return MergeJoinExec(plan, build_executor(plan.children[0], use_tpu),
                             build_executor(plan.children[1], use_tpu))
    if isinstance(plan, PhysicalHashJoin):
        return HashJoinExec(plan, build_executor(plan.children[0], use_tpu),
                            build_executor(plan.children[1], use_tpu))
    if isinstance(plan, PhysicalSort):
        return SortExec(plan, build_executor(plan.children[0], use_tpu))
    if isinstance(plan, PhysicalTopN):
        return TopNExec(plan, build_executor(plan.children[0], use_tpu))
    if isinstance(plan, PhysicalLimit):
        return LimitExec(plan, build_executor(plan.children[0], use_tpu))
    if isinstance(plan, PhysicalTableDual):
        return TableDualExec(plan)
    raise ValueError(f"no executor for {type(plan).__name__}")

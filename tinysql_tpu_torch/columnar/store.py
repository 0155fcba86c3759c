"""Columnar table store — the analytics fast path.

TPU-first design decision (no direct reference counterpart; the TiFlash
analogue of TiDB's row store): analytical scans read contiguous numpy
columns that marshal straight onto device HBM, instead of decoding
rowcodec values row-by-row.  The row-oriented KV + 2PC path (SURVEY §2.6)
remains the write path and source of truth; this store is a cache/replica:

- `bulk_load` ingests whole tables column-wise (the LOAD DATA analogue).
- A full KV scan hydrates the cache as a side effect.
- Any committed write touching a table bumps its data version
  (hooked in the 2PC committer), invalidating the replica.
- A transaction may read the replica only if it has no buffered writes on
  the table and the replica was built from data unchanged since the txn's
  snapshot.
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..catalog.model import TableInfo
from ..mytypes import EvalType
from ..obs import memprof as _memprof


@dataclass
class ColumnarTable:
    table_id: int
    n_rows: int
    built_ts: int                  # oracle ts when built
    data_version: int              # storage table-version at build
    # col_id -> (values ndarray, null ndarray); handles as int64 array
    columns: Dict[int, Tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    handles: Optional[np.ndarray] = None
    # derived-state memo (device-resident padded uploads, string dictionary
    # codes) — lives and dies with this replica version, so invalidation is
    # free: a bump drops the whole ColumnarTable
    cache: Dict[object, object] = field(default_factory=dict)

    def memo(self, key, build):
        v = self.cache.get(key)
        if v is None:
            v = self.cache[key] = build()
        return v


#: every live store, weakly held — the HBM census walks them to claim
#: replica-memoized device buffers, and the spill gates read measured
#: row widths off them (obs/memprof.measured_row_bytes)
_STORES: "weakref.WeakSet[ColumnarStore]" = weakref.WeakSet()


def live_stores() -> List["ColumnarStore"]:
    return list(_STORES)


class ColumnarStore:
    def __init__(self):
        self._tables: Dict[int, ColumnarTable] = {}
        self._mu = threading.Lock()
        _STORES.add(self)

    def tables_snapshot(self) -> List[ColumnarTable]:
        with self._mu:
            return list(self._tables.values())

    def get(self, table_id: int) -> Optional[ColumnarTable]:
        with self._mu:
            return self._tables.get(table_id)

    def put(self, tbl: ColumnarTable) -> None:
        with self._mu:
            self._tables[tbl.table_id] = tbl

    def invalidate(self, table_id: int) -> None:
        with self._mu:
            self._tables.pop(table_id, None)


def _replica_memo_values():
    """HBM census walker: every replica's derived-state memo values —
    where ALL long-lived device buffers in the engine are born
    (rep.memo(..., lambda: kernels.h2d(...)) in the executors)."""
    for s in live_stores():
        for tbl in s.tables_snapshot():
            yield list(tbl.cache.values())


_memprof.register_census_walker("replica", _replica_memo_values)


def store_of(storage) -> ColumnarStore:
    s = getattr(storage, "_columnar", None)
    if s is None:
        s = storage._columnar = ColumnarStore()
    return s


def table_data_version(storage, table_id: int) -> int:
    versions = getattr(storage, "_table_versions", None)
    if versions is None:
        versions = storage._table_versions = {}
    return versions.get(table_id, (0, 0))[0]


def table_version_ts(storage, table_id: int) -> int:
    """Oracle ts at which the table's data version was last bumped: a
    snapshot at/after this ts sees all data of the current version."""
    versions = getattr(storage, "_table_versions", None)
    if versions is None:
        versions = storage._table_versions = {}
    return versions.get(table_id, (0, 0))[1]


def bump_table_version(storage, table_id: int) -> None:
    versions = getattr(storage, "_table_versions", None)
    if versions is None:
        versions = storage._table_versions = {}
    ver = versions.get(table_id, (0, 0))[0]
    versions[table_id] = (ver + 1, storage.current_version())
    store_of(storage).invalidate(table_id)


def replica_for_read(storage, txn, table_id: int) -> Optional[ColumnarTable]:
    """The replica is readable by `txn` iff it reflects exactly the data the
    txn's snapshot would see and the txn has no own writes on the table."""
    rep = store_of(storage).get(table_id)
    if rep is None:
        return None
    if rep.data_version != table_data_version(storage, table_id):
        return None
    if txn is not None and rep.built_ts > txn.start_ts:
        return None  # built from newer data than the snapshot
    if txn is not None and _txn_touches_table(txn, table_id):
        return None
    return rep


def _txn_touches_table(txn, table_id: int) -> bool:
    from ..codec import tablecodec
    prefix = tablecodec.encode_table_prefix(table_id)
    for k, _ in txn.us.buffer.iter_range(prefix, prefix + b"\xff" * 20):
        return True
    return False


def _np_dtype(et: EvalType):
    if et is EvalType.INT:
        return np.int64
    if et is EvalType.REAL:
        return np.float64
    return object


def bulk_load(storage, info: TableInfo,
              data: Dict[str, np.ndarray],
              nulls: Optional[Dict[str, np.ndarray]] = None,
              handles: Optional[np.ndarray] = None) -> int:
    """Columnar bulk ingest (LOAD DATA analogue): columns keyed by name.
    Writes the replica AND the row-store contract metadata (row count via
    handles).  Returns n_rows."""
    nulls = nulls or {}
    cols: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    n = None
    for c in info.public_columns():
        if c.name not in data:
            raise ValueError(f"bulk_load missing column {c.name}")
        v = np.asarray(data[c.name])
        dt = _np_dtype(c.ft.eval_type)
        if dt is object:
            # keep fixed-width <U dtype: string filters vectorize in C
            if v.dtype.kind != "U":
                v = v.astype(str)
        else:
            v = v.astype(dt)
        m = np.asarray(nulls.get(c.name, np.zeros(len(v), dtype=bool)),
                       dtype=bool)
        if n is None:
            n = len(v)
        assert len(v) == n and len(m) == n
        cols[c.id] = (v, m)
    if handles is None:
        # a clustered int PK *is* the handle: the replica's handle array
        # must carry the PK VALUES, not a synthetic row number —
        # otherwise PK predicates (handle ranges) select the wrong rows
        pk = info.get_pk_handle_col()
        if pk is not None and pk.name in data:
            handles = np.asarray(data[pk.name], dtype=np.int64)
        else:
            handles = np.arange(1, (n or 0) + 1, dtype=np.int64)
    ver = table_data_version(storage, info.id)
    rep = ColumnarTable(info.id, n or 0, storage.current_version(), ver,
                        cols, np.asarray(handles, dtype=np.int64))
    store_of(storage).put(rep)
    # bulk ingest bypasses add_record, so feed the live stats count here
    # (keeps planner estimates and the TPU row-gate truthful); absolute
    # set — the replica REPLACES the table's contents
    from ..statistics.table_stats import set_count
    set_count(storage, info.id, n or 0)
    return n or 0


def replica_from_numpy(storage, info: TableInfo,
                       columns: Dict[int, Tuple[np.ndarray, np.ndarray]],
                       handles: Optional[np.ndarray] = None) -> int:
    """Install a replica built from host numpy columns keyed by column id
    — exactly the ``(values, null)`` pairs another replica holds (the
    reference package's ``ColumnarTable.columns``), so two engines read
    identical data.  The arrays are copied, never shared.  Device
    uploads happen on first use and are memoized on the replica per
    version and device (executor/gpu_executors.py).  Returns the row
    count."""
    data, nulls = {}, {}
    for c in info.public_columns():
        if c.id not in columns:
            raise ValueError(f"replica_from_numpy missing column {c.name}")
        v, m = columns[c.id]
        data[c.name] = np.array(v, copy=True)
        nulls[c.name] = np.array(m, dtype=bool, copy=True)
    return bulk_load(storage, info, data, nulls,
                     None if handles is None
                     else np.array(handles, dtype=np.int64, copy=True))


def ensure_row_store(storage, info: TableInfo) -> int:
    """Materialize a bulk-loaded table into the MVCC row store before
    its first WRITE statement.  ``bulk_load`` writes ONLY the columnar
    replica; a write statement commits through the row store and bumps
    the table version — invalidating the replica and silently dropping
    every row the write didn't touch.  This backfills the replica's
    rows (indices included, via the Table write path) directly into
    MVCC at the replica's BUILD timestamp: the rows logically existed
    since the bulk load, every snapshot >= built_ts already serves them
    from the replica, and open transactions (start_ts > built_ts) see
    values identical to what they were reading — so no version bump and
    the replica stays valid until the write's own commit.  No-op unless
    the table is replica-only (valid replica, empty row store); returns
    the number of rows installed."""
    from ..catalog.table import Table
    from ..codec import tablecodec
    from ..kv.txn import Transaction
    rep = store_of(storage).get(info.id)
    if rep is None or rep.n_rows == 0:
        return 0
    if rep.data_version != table_data_version(storage, info.id):
        return 0  # stale replica: the row store is already the truth
    lo, hi = tablecodec.record_range(info.id)
    from ..kv.errors import KeyIsLocked
    try:
        if storage.mvcc.scan(lo, hi, storage.current_version(), limit=1):
            return 0  # row store already populated
    except KeyIsLocked:
        # an in-flight writer holds a record lock — every writer passes
        # through this gate first, so materialization already ran
        return 0
    tbl = Table(info)
    scratch = Transaction(storage, rep.built_ts)
    n_cols = len(info.columns)
    pub = [(c, rep.columns.get(c.id)) for c in info.public_columns()]
    handles = rep.handles
    for i in range(rep.n_rows):
        row = [None] * n_cols
        for c, pair in pub:
            if pair is None:
                continue
            v, m = pair
            if not m[i]:
                x = v[i]
                row[c.offset] = str(x) if v.dtype.kind == "U" \
                    else x.item()
        tbl.add_record(scratch, row, handle=int(handles[i]))
    # the scratch buffer holds only puts (add_record never deletes), so
    # every entry backfills verbatim — row records and index entries
    return storage.mvcc.backfill(list(scratch.us.buffer._m.items()),
                                 rep.built_ts)


def hydrate_from_scan(storage, txn, info: TableInfo,
                      col_ids: List[int],
                      arrays: Dict[int, Tuple[np.ndarray, np.ndarray]],
                      handles: np.ndarray) -> None:
    """Cache the result of a completed full scan (only when the txn could
    have used a replica, i.e. it had no own writes).

    Staleness gate: the scan saw data as of txn.start_ts.  If the table's
    version was bumped AFTER that snapshot, the scan is missing newer
    committed rows and must not be published under the current version."""
    if _txn_touches_table(txn, info.id):
        return
    if txn.start_ts < table_version_ts(storage, info.id):
        return  # snapshot predates the current data version
    existing = store_of(storage).get(info.id)
    ver = table_data_version(storage, info.id)
    if existing is not None and existing.data_version == ver:
        existing.columns.update(arrays)
        return
    rep = ColumnarTable(info.id, len(handles), txn.start_ts, ver,
                        dict(arrays), handles)
    store_of(storage).put(rep)

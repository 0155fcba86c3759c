"""Row-level table abstraction over KV.

Capability parity with reference table/table.go:126 (Table iface:
AddRecord/RemoveRecord/Row/Allocator), table/tables/tables.go (row encode +
per-index maintenance on the write path) and table/tables/index.go:103,194
(index kv create/delete/seek).  Schema-state gating implements the F1
online-DDL write rules: WRITE_ONLY columns/indices are maintained but not
readable; DELETE_ONLY indices only see deletes.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from ..codec import keycodec, rowcodec, tablecodec
from ..kv.errors import KeyExists, KeyNotFound
from ..mytypes import Datum, cast_datum, FLAG_PRI_KEY
from .autoid import Allocator
from .model import ColumnInfo, IndexInfo, SchemaState, TableInfo


class DuplicateKeyError(Exception):
    def __init__(self, table: str, index: str, values):
        super().__init__(f"Duplicate entry {values!r} for key '{table}.{index}'")
        self.index = index
        self.values = values


class Index:
    """One index's KV encoding (reference: tables/index.go)."""

    def __init__(self, table: "Table", info: IndexInfo):
        self.table = table
        self.info = info

    def _index_values(self, row: List[Datum]) -> List[Datum]:
        vals = []
        for ic in self.info.columns:
            v = row[ic.offset]
            if ic.length >= 0 and isinstance(v, str):
                v = v[:ic.length]
            vals.append(v)
        return vals

    def _unsigned_flags(self) -> List[bool]:
        """Unsigned columns must encode with the UINT key flag or values
        >= 2^63 sort before 0 in the index (and range seeks miss)."""
        out = []
        for ic in self.info.columns:
            ci = self.table.info.find_column(ic.name)
            out.append(bool(ci is not None and ci.ft.is_unsigned))
        return out

    def key(self, row: List[Datum], handle: int) -> Tuple[bytes, bytes]:
        """Returns (key, value).  Unique index: handle in value (unless NULLs
        present); non-unique: handle in key (reference: index.go:103)."""
        vals = self._index_values(row)
        has_null = any(v is None for v in vals)
        tid = self.table.info.id
        uns = self._unsigned_flags()
        if self.info.unique and not has_null:
            k = tablecodec.encode_index_key(tid, self.info.id, vals,
                                            unsigned_flags=uns)
            return k, b"%d" % handle
        k = tablecodec.encode_index_key(tid, self.info.id, vals,
                                        handle=handle, unsigned_flags=uns)
        return k, b"0"

    def create(self, txn, row: List[Datum], handle: int) -> None:
        k, v = self.key(row, handle)
        vals = self._index_values(row)
        if self.info.unique and not any(x is None for x in vals):
            txn.insert(k, v, dup_err=DuplicateKeyError(
                self.table.info.name, self.info.name, vals))
        else:
            txn.set(k, v)

    def delete(self, txn, row: List[Datum], handle: int) -> None:
        k, _ = self.key(row, handle)
        txn.delete(k)

    def exists_conflict(self, txn, row: List[Datum]) -> Optional[int]:
        """Pre-check for REPLACE/dup detection: returns conflicting handle
        (reference: executor/batch_checker.go)."""
        if not self.info.unique:
            return None
        vals = self._index_values(row)
        if any(v is None for v in vals):
            return None
        k = tablecodec.encode_index_key(self.table.info.id, self.info.id,
                                        vals,
                                        unsigned_flags=self._unsigned_flags())
        try:
            return int(txn.get(k))
        except KeyNotFound:
            return None


class Table:
    """reference: table/tables/tables.go tableCommon."""

    def __init__(self, info: TableInfo, allocator: Optional[Allocator] = None):
        self.info = info
        self.allocator = allocator
        self.indices = [Index(self, ii) for ii in info.indices]

    # ---- handle / autoid ------------------------------------------------
    def _alloc_handle(self, txn) -> int:
        assert self.allocator is not None, "table has no allocator bound"
        return self.allocator.alloc()

    def handle_for_row(self, txn, row: List[Datum]) -> int:
        pk = self.info.get_pk_handle_col()
        if pk is not None and row[pk.offset] is not None:
            h = int(row[pk.offset])
            if self.allocator is not None:
                self.allocator.rebase(h)
            return h
        return self._alloc_handle(txn)

    # ---- write path -----------------------------------------------------
    def add_record(self, txn, row: List[Datum],
                   handle: Optional[int] = None) -> int:
        """Insert one row: encode row value, write record key, maintain every
        writable index (reference: tables.go AddRecord)."""
        # `row` is indexed by column offset over ALL of info.columns; values
        # at non-writable offsets are ignored.  Cast writable cells in place
        # (no compaction — offsets must stay valid for index encoding).
        row = list(row)
        for c in self.info.writable_columns():
            if row[c.offset] is not None:
                row[c.offset] = cast_datum(row[c.offset], c.ft)
            else:
                row[c.offset] = None
        if handle is None:
            handle = self.handle_for_row(txn, row)
        rec_key = tablecodec.encode_row_key(self.info.id, handle)
        pk = self.info.get_pk_handle_col()
        if pk is not None:
            # pk-as-handle: uniqueness enforced on the record key itself
            txn.insert(rec_key, self._encode_row(row, handle),
                       dup_err=DuplicateKeyError(self.info.name, "PRIMARY", [handle]))
        else:
            txn.set(rec_key, self._encode_row(row, handle))
        for idx in self.indices:
            if idx.info.state >= SchemaState.WRITE_ONLY:
                idx.create(txn, row, handle)
        self._bump(txn, +1)
        return handle

    def remove_record(self, txn, handle: int, row: List[Datum]) -> None:
        txn.delete(tablecodec.encode_row_key(self.info.id, handle))
        for idx in self.indices:
            if idx.info.state >= SchemaState.DELETE_ONLY:
                idx.delete(txn, row, handle)
        self._bump(txn, -1)

    def _bump(self, txn, d: int) -> None:
        """Net row-count delta, applied to live stats at commit."""
        sd = getattr(txn, "stats_delta", None)
        if sd is not None:
            sd[self.info.id] = sd.get(self.info.id, 0) + d

    def update_record(self, txn, handle: int, old_row: List[Datum],
                      new_row: List[Datum]) -> None:
        """Used by DDL reorg and REPLACE (reference: tables.go UpdateRecord)."""
        self.remove_record(txn, handle, old_row)
        self.add_record(txn, new_row, handle)

    def _encode_row(self, row: List[Datum], handle: int) -> bytes:
        vals: Dict[int, Datum] = {}
        pk = self.info.get_pk_handle_col()
        for c in self.info.writable_columns():
            if pk is not None and c.id == pk.id:
                continue  # pk-as-handle lives in the key, not the value
            vals[c.id] = row[c.offset]
        return rowcodec.encode_row(vals)

    # ---- read path ------------------------------------------------------
    def decode_row(self, value: bytes, handle: int,
                   cols: Optional[List[ColumnInfo]] = None) -> List[Datum]:
        cols = cols if cols is not None else self.info.public_columns()
        pk = self.info.get_pk_handle_col()
        out = rowcodec.decode_row_to_datums(
            value, [c.id for c in cols], [c.ft for c in cols],
            defaults=[c.default for c in cols])
        if pk is not None:
            for i, c in enumerate(cols):
                if c.id == pk.id:
                    out[i] = handle
        return out

    def row(self, txn, handle: int,
            cols: Optional[List[ColumnInfo]] = None) -> List[Datum]:
        v = txn.get(tablecodec.encode_row_key(self.info.id, handle))
        return self.decode_row(v, handle, cols)

    def iter_records(self, txn, start_handle: Optional[int] = None,
                     cols: Optional[List[ColumnInfo]] = None
                     ) -> Iterator[Tuple[int, List[Datum]]]:
        """Scan records in handle order, decoding only `cols` (column
        pruning reaches all the way to the decode loop)."""
        lo, hi = tablecodec.record_range(self.info.id)
        if start_handle is not None:
            lo = tablecodec.encode_row_key(self.info.id, start_handle)
        for k, v in txn.iter_range(lo, hi):
            _, handle = tablecodec.decode_record_key(k)
            yield handle, self.decode_row(v, handle, cols)

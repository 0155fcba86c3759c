"""DML write executors: INSERT / REPLACE / DELETE.

Capability parity with reference executor/insert.go + insert_common.go
(value evaluation, defaults, autoid), replace.go (delete-then-insert on
duplicate), delete.go, batch_checker.go (dup-key detection).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..catalog.autoid import Allocator
from ..catalog.model import TableInfo
from ..catalog.table import DuplicateKeyError, Table
from ..codec import tablecodec
from ..expression import Constant, Schema
from ..kv.errors import KeyNotFound
from ..mytypes import FLAG_AUTO_INCREMENT, FLAG_NOT_NULL, Datum, cast_datum
from ..parser import ast


class WriteError(Exception):
    pass


def get_allocator(storage, tid: int) -> Allocator:
    cache = getattr(storage, "_allocators", None)
    if cache is None:
        cache = storage._allocators = {}
    a = cache.get(tid)
    if a is None:
        a = cache[tid] = Allocator(storage, tid)
    return a


class InsertExec:
    """reference: executor/insert.go InsertExec + replace.go ReplaceExec."""

    def __init__(self, session, stmt: ast.InsertStmt, info: TableInfo,
                 db_name: str):
        self.session = session
        self.stmt = stmt
        self.info = info
        self.db_name = db_name
        self.affected = 0

    def execute(self, txn) -> int:
        info = self.info
        tbl = Table(info, get_allocator(self.session.storage, info.id))
        cols = info.public_columns()
        by_name = {c.name.lower(): c for c in cols}
        if self.stmt.columns:
            target = []
            for name in self.stmt.columns:
                c = by_name.get(name.lower())
                if c is None:
                    raise WriteError(f"Unknown column '{name}' in 'field list'")
                target.append(c)
        else:
            target = cols

        rows: List[List[Datum]] = []
        if self.stmt.select is not None:
            src_rows = self.session._run_select_plan(self.stmt.select, txn)
            for r in src_rows:
                if len(r) != len(target):
                    raise WriteError("Column count doesn't match value count")
                rows.append(self._complete_row(tbl, target, list(r)))
        else:
            for lst in self.stmt.lists:
                if len(lst) != len(target):
                    raise WriteError("Column count doesn't match value count "
                                     f"at row {len(rows) + 1}")
                vals = [self._eval_insert_expr(e, target[i])
                        for i, e in enumerate(lst)]
                rows.append(self._complete_row(tbl, target, vals))

        for row in rows:
            if self.stmt.is_replace:
                self._replace_row(txn, tbl, row)
            else:
                self._check_duplicates(txn, tbl, row)
                tbl.add_record(txn, row)
            self.affected += 1
        return self.affected

    def _check_duplicates(self, txn, tbl: Table, row: List[Datum]) -> None:
        """Eager dup detection so INSERT fails at the statement, not at
        commit (reference: executor/batch_checker.go getKeysNeedCheck);
        the prewrite check remains the backstop for concurrent races."""
        pk = self.info.get_pk_handle_col()
        if pk is not None and row[pk.offset] is not None:
            h = int(row[pk.offset])
            try:
                txn.get(tablecodec.encode_row_key(self.info.id, h))
                raise DuplicateKeyError(self.info.name, "PRIMARY", [h])
            except KeyNotFound:
                pass
        for idx in tbl.indices:
            if idx.info.unique and idx.exists_conflict(txn, row) is not None:
                raise DuplicateKeyError(self.info.name, idx.info.name,
                                        idx._index_values(row))

    # ---- helpers --------------------------------------------------------
    def _eval_insert_expr(self, e: ast.ExprNode, col) -> Datum:
        if isinstance(e, ast.DefaultExpr):
            return col.default
        return self.session.eval_const_expr(e)

    def _complete_row(self, tbl: Table, target, vals: List[Datum]) -> List[Datum]:
        """Order values by column offset, fill defaults/autoid, check
        NOT NULL (reference: insert_common.go getRow/fillRow)."""
        info = self.info
        by_offset: Dict[int, Datum] = {}
        for c, v in zip(target, vals):
            by_offset[c.offset] = v
        row: List[Datum] = []
        for c in info.public_columns():
            v = by_offset.get(c.offset, c.default)
            if v is None and (c.ft.flag & FLAG_AUTO_INCREMENT):
                v = tbl.allocator.alloc()
            elif v is not None and (c.ft.flag & FLAG_AUTO_INCREMENT):
                v = cast_datum(v, c.ft)
                tbl.allocator.rebase(int(v))
            if v is None and c.ft.not_null:
                if c.offset in by_offset:
                    raise WriteError(f"Column '{c.name}' cannot be null")
                raise WriteError(f"Field '{c.name}' doesn't have a default value")
            row.append(cast_datum(v, c.ft) if v is not None else None)
        return row

    def _replace_row(self, txn, tbl: Table, row: List[Datum]) -> None:
        """REPLACE: remove any row conflicting on pk or unique keys, then
        insert (reference: replace.go removeRow + addRecord)."""
        info = self.info
        removed = True
        while removed:
            removed = False
            pk = info.get_pk_handle_col()
            if pk is not None and row[pk.offset] is not None:
                h = int(row[pk.offset])
                try:
                    old = tbl.row(txn, h)
                except KeyNotFound:
                    old = None
                if old is not None:
                    tbl.remove_record(txn, h, old)
                    removed = True
            for idx in tbl.indices:
                if not idx.info.unique:
                    continue
                h = idx.exists_conflict(txn, row)
                if h is not None:
                    old = tbl.row(txn, h)
                    tbl.remove_record(txn, h, old)
                    removed = True
        tbl.add_record(txn, row)


class UpdateExec:
    """reference: executor/update.go UpdateExec — read-modify-write over
    the scanned qualifying rows (the plan carries the hidden handle
    column), riding the SAME row-store + 2PC prewrite/commit path as
    INSERT/DELETE, so every transactional guarantee (and failpoint) of
    that path covers UPDATE for free."""

    def __init__(self, session, info: TableInfo, assigns):
        # assigns: [(ColumnInfo, Expression bound to scan-schema offsets)]
        self.session = session
        self.info = info
        self.assigns = assigns
        self.affected = 0

    def execute(self, txn, rows: List[list]) -> int:
        tbl = Table(self.info, get_allocator(self.session.storage,
                                             self.info.id))
        pk = self.info.get_pk_handle_col()
        for row in rows:
            handle = row[-1]
            old = row[:-1]
            new = list(old)
            for ci, expr in self.assigns:
                # MySQL single-table UPDATE evaluates assignments left to
                # right, each seeing the values already assigned
                v = expr.eval(new + [handle])
                if v is None and ci.ft.not_null:
                    raise WriteError(f"Column '{ci.name}' cannot be null")
                new[ci.offset] = cast_datum(v, ci.ft) if v is not None \
                    else None
            if new == old:
                continue  # no-op assignment: nothing to write
            if pk is not None and new[pk.offset] != handle:
                # handle change: the row MOVES in the keyspace
                new_handle = int(new[pk.offset])
                try:
                    txn.get(tablecodec.encode_row_key(self.info.id,
                                                      new_handle))
                    raise DuplicateKeyError(self.info.name, "PRIMARY",
                                            [new_handle])
                except KeyNotFound:
                    pass
                # eager 1062 at STATEMENT time, same as the in-place
                # branch — not deferred to commit-time prewrite
                self._check_unique(txn, tbl, old, new, handle)
                tbl.remove_record(txn, handle, old)
                tbl.add_record(txn, new)
            else:
                self._check_unique(txn, tbl, old, new, handle)
                tbl.update_record(txn, handle, old, new)
            self.affected += 1
        return self.affected

    def _check_unique(self, txn, tbl: Table, old, new,
                      handle: int) -> None:
        for idx in tbl.indices:
            if not idx.info.unique:
                continue
            if idx._index_values(old) == idx._index_values(new):
                continue  # key unchanged: no new conflict possible
            h = idx.exists_conflict(txn, new)
            if h is not None and h != handle:
                raise DuplicateKeyError(self.info.name, idx.info.name,
                                        idx._index_values(new))


class DeleteExec:
    """reference: executor/delete.go — scan qualifying rows (plan includes
    the hidden handle column), remove each."""

    def __init__(self, session, info: TableInfo):
        self.session = session
        self.info = info
        self.affected = 0

    def execute(self, txn, rows: List[list]) -> int:
        tbl = Table(self.info)
        for row in rows:
            handle = row[-1]
            tbl.remove_record(txn, handle, row[:-1])
            self.affected += 1
        return self.affected

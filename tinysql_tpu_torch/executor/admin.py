"""ADMIN CHECK TABLE: verify record/index consistency.

Capability parity with reference util/admin (CheckIndicesCount /
ScanIndexData consistency checks used by executor admin statements).
"""
from __future__ import annotations

from ..catalog.model import SchemaState, TableInfo
from ..catalog.table import Index, Table
from ..codec import tablecodec


class AdminCheckError(Exception):
    pass


def check_table(storage, info: TableInfo) -> None:
    txn = storage.begin()
    try:
        tbl = Table(info)
        rows = {h: row for h, row in tbl.iter_records(txn)}
        for idx in tbl.indices:
            if idx.info.state != SchemaState.PUBLIC:
                continue
            lo, hi = tablecodec.index_range(info.id, idx.info.id)
            entries = list(txn.iter_range(lo, hi))
            if len(entries) != len(rows):
                raise AdminCheckError(
                    f"index '{idx.info.name}' has {len(entries)} entries, "
                    f"table has {len(rows)} rows")
            for k, v in entries:
                _, _, vals = tablecodec.decode_index_key(k)
                if idx.info.unique and v not in (b"0",):
                    handle = int(v)
                else:
                    handle = vals[-1]
                    vals = vals[:-1]
                if handle not in rows:
                    raise AdminCheckError(
                        f"index '{idx.info.name}' entry {vals!r} points to "
                        f"missing handle {handle}")
    finally:
        txn.rollback()

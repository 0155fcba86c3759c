"""Schema metadata model.

Capability parity with reference parser/model/model.go: DBInfo / TableInfo /
ColumnInfo / IndexInfo and the F1 online-schema-change state enum
StateNone→DeleteOnly→WriteOnly→WriteReorganization→Public (model.go:32-44),
plus the DDL Job model (parser/model/ddl.go).  Everything JSON round-trips
because it is persisted in the KV meta layer.
"""
from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..mytypes import (FieldType, Datum, TYPE_LONGLONG)


class SchemaState(enum.IntEnum):
    """F1 schema states (reference: model.go:32-44)."""
    NONE = 0
    DELETE_ONLY = 1
    WRITE_ONLY = 2
    WRITE_REORG = 3
    PUBLIC = 4


class JobState(enum.IntEnum):
    """DDL job states (reference: parser/model/ddl.go JobState)."""
    NONE = 0
    RUNNING = 1
    ROLLINGBACK = 2
    ROLLBACK_DONE = 3
    DONE = 4
    CANCELLED = 5
    SYNCED = 6


class ActionType(enum.IntEnum):
    """reference: parser/model/ddl.go ActionType (tinysql subset)."""
    CREATE_SCHEMA = 1
    DROP_SCHEMA = 2
    CREATE_TABLE = 3
    DROP_TABLE = 4
    ADD_COLUMN = 5
    DROP_COLUMN = 6
    ADD_INDEX = 7
    DROP_INDEX = 8
    TRUNCATE_TABLE = 11


@dataclass
class ColumnInfo:
    id: int
    name: str
    offset: int
    ft: FieldType
    default: Optional[Datum] = None
    state: SchemaState = SchemaState.PUBLIC

    def to_dict(self) -> dict:
        return {"id": self.id, "name": self.name, "offset": self.offset,
                "tp": self.ft.tp, "flag": self.ft.flag, "flen": self.ft.flen,
                "default": self.default, "state": int(self.state)}

    @classmethod
    def from_dict(cls, d: dict) -> "ColumnInfo":
        return cls(d["id"], d["name"], d["offset"],
                   FieldType(d["tp"], d["flag"], d["flen"]),
                   d.get("default"), SchemaState(d["state"]))


@dataclass
class IndexColumn:
    name: str
    offset: int
    length: int = -1  # prefix length; -1 = whole column


@dataclass
class IndexInfo:
    id: int
    name: str
    columns: List[IndexColumn]
    unique: bool = False
    primary: bool = False
    state: SchemaState = SchemaState.PUBLIC

    def to_dict(self) -> dict:
        return {"id": self.id, "name": self.name,
                "columns": [[c.name, c.offset, c.length] for c in self.columns],
                "unique": self.unique, "primary": self.primary,
                "state": int(self.state)}

    @classmethod
    def from_dict(cls, d: dict) -> "IndexInfo":
        return cls(d["id"], d["name"],
                   [IndexColumn(*c) for c in d["columns"]],
                   d["unique"], d["primary"], SchemaState(d["state"]))


@dataclass
class TableInfo:
    id: int
    name: str
    columns: List[ColumnInfo] = field(default_factory=list)
    indices: List[IndexInfo] = field(default_factory=list)
    pk_is_handle: bool = False   # int PK stored as the row handle
    max_column_id: int = 0
    max_index_id: int = 0
    state: SchemaState = SchemaState.PUBLIC
    update_ts: int = 0

    def get_pk_handle_col(self) -> Optional[ColumnInfo]:
        if not self.pk_is_handle:
            return None
        from ..mytypes import FLAG_PRI_KEY
        for c in self.columns:
            if c.ft.flag & FLAG_PRI_KEY:
                return c
        return None

    def find_column(self, name: str) -> Optional[ColumnInfo]:
        lname = name.lower()
        for c in self.columns:
            if c.name.lower() == lname:
                return c
        return None

    def find_index(self, name: str) -> Optional[IndexInfo]:
        lname = name.lower()
        for i in self.indices:
            if i.name.lower() == lname:
                return i
        return None

    def public_columns(self) -> List[ColumnInfo]:
        return [c for c in self.columns if c.state == SchemaState.PUBLIC]

    def writable_columns(self) -> List[ColumnInfo]:
        return [c for c in self.columns if c.state >= SchemaState.WRITE_ONLY]

    def public_indices(self) -> List[IndexInfo]:
        return [i for i in self.indices if i.state == SchemaState.PUBLIC]

    def writable_indices(self) -> List[IndexInfo]:
        return [i for i in self.indices if i.state >= SchemaState.WRITE_ONLY]

    def deletable_indices(self) -> List[IndexInfo]:
        return [i for i in self.indices if i.state >= SchemaState.DELETE_ONLY]

    def to_dict(self) -> dict:
        return {"id": self.id, "name": self.name,
                "columns": [c.to_dict() for c in self.columns],
                "indices": [i.to_dict() for i in self.indices],
                "pk_is_handle": self.pk_is_handle,
                "max_column_id": self.max_column_id,
                "max_index_id": self.max_index_id,
                "state": int(self.state), "update_ts": self.update_ts}

    @classmethod
    def from_dict(cls, d: dict) -> "TableInfo":
        return cls(d["id"], d["name"],
                   [ColumnInfo.from_dict(c) for c in d["columns"]],
                   [IndexInfo.from_dict(i) for i in d["indices"]],
                   d["pk_is_handle"], d["max_column_id"], d["max_index_id"],
                   SchemaState(d["state"]), d.get("update_ts", 0))

    def clone(self) -> "TableInfo":
        return TableInfo.from_dict(self.to_dict())


@dataclass
class DBInfo:
    id: int
    name: str
    state: SchemaState = SchemaState.PUBLIC

    def to_dict(self) -> dict:
        return {"id": self.id, "name": self.name, "state": int(self.state)}

    @classmethod
    def from_dict(cls, d: dict) -> "DBInfo":
        return cls(d["id"], d["name"], SchemaState(d["state"]))


@dataclass
class Job:
    """Async DDL job (reference: parser/model/ddl.go Job)."""
    id: int
    tp: ActionType
    schema_id: int
    table_id: int
    args: List[Any] = field(default_factory=list)
    state: JobState = JobState.NONE
    schema_state: SchemaState = SchemaState.NONE
    schema_version: int = 0
    error: Optional[str] = None
    snapshot_ver: int = 0      # reorg progress snapshot
    reorg_handle: int = 0      # reorg backfill checkpoint (reference: ddl/reorg.go)
    row_count: int = 0

    def to_json(self) -> str:
        return json.dumps({
            "id": self.id, "tp": int(self.tp), "schema_id": self.schema_id,
            "table_id": self.table_id, "args": self.args,
            "state": int(self.state), "schema_state": int(self.schema_state),
            "schema_version": self.schema_version, "error": self.error,
            "snapshot_ver": self.snapshot_ver,
            "reorg_handle": self.reorg_handle, "row_count": self.row_count})

    @classmethod
    def from_json(cls, s: str) -> "Job":
        d = json.loads(s)
        return cls(d["id"], ActionType(d["tp"]), d["schema_id"], d["table_id"],
                   d["args"], JobState(d["state"]), SchemaState(d["schema_state"]),
                   d["schema_version"], d.get("error"),
                   d.get("snapshot_ver", 0), d.get("reorg_handle", 0),
                   d.get("row_count", 0))

    def is_finished(self) -> bool:
        return self.state in (JobState.DONE, JobState.SYNCED,
                              JobState.CANCELLED, JobState.ROLLBACK_DONE)

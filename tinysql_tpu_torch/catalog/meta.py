"""Catalog persisted in KV under the `m` prefix.

Capability parity with reference meta/meta.go:79-471 (+ structure/*.go
encodings): DBInfo/TableInfo CRUD, global ID and schema-version counters,
DDL job queues (general queue, history).  Keys sort *outside* the table data
keyspace (`m` < `t`), so meta scans never collide with row scans.
"""
from __future__ import annotations

import json
import struct
from typing import List, Optional

from ..kv.errors import KeyNotFound
from .model import DBInfo, Job, TableInfo

M_PREFIX = b"m"
_DB_PREFIX = b"m:db:"              # m:db:{db_id:08d} -> DBInfo
_TABLE_PREFIX = b"m:tbl:"          # m:tbl:{db_id:08d}:{tid:08d} -> TableInfo
_GLOBAL_ID_KEY = b"m:next_gid"
_SCHEMA_VER_KEY = b"m:schema_ver"
_AUTOID_PREFIX = b"m:autoid:"      # m:autoid:{tid:08d} -> int
_JOB_QUEUE_KEY = b"m:ddl_jobq"     # json list of job jsons (small, teaching-scale)
_JOB_HISTORY_PREFIX = b"m:ddl_hist:"  # m:ddl_hist:{job_id:016d} -> job json
_BOOTSTRAP_KEY = b"m:bootstrapped"


def _db_key(db_id: int) -> bytes:
    return _DB_PREFIX + b"%08d" % db_id


def _table_key(db_id: int, tid: int) -> bytes:
    return _TABLE_PREFIX + b"%08d:%08d" % (db_id, tid)


class Meta:
    """Catalog accessor bound to one KV transaction (reference: meta.Meta)."""

    def __init__(self, txn):
        self.txn = txn

    # ---- counters -------------------------------------------------------
    def _get_int(self, key: bytes, default: int = 0) -> int:
        try:
            return int(self.txn.get(key))
        except KeyNotFound:
            return default

    def _set_int(self, key: bytes, v: int) -> None:
        self.txn.set(key, b"%d" % v)

    def gen_global_id(self) -> int:
        v = self._get_int(_GLOBAL_ID_KEY) + 1
        self._set_int(_GLOBAL_ID_KEY, v)
        return v

    def schema_version(self) -> int:
        return self._get_int(_SCHEMA_VER_KEY)

    def bump_schema_version(self) -> int:
        v = self._get_int(_SCHEMA_VER_KEY) + 1
        self._set_int(_SCHEMA_VER_KEY, v)
        return v

    # ---- autoid ---------------------------------------------------------
    def autoid(self, tid: int) -> int:
        return self._get_int(_AUTOID_PREFIX + b"%08d" % tid)

    def advance_autoid(self, tid: int, step: int) -> int:
        """Reserve [cur+1, cur+step]; returns new high-water mark
        (reference: meta/autoid batched Alloc)."""
        v = self.autoid(tid) + step
        self._set_int(_AUTOID_PREFIX + b"%08d" % tid, v)
        return v

    def rebase_autoid(self, tid: int, at_least: int) -> None:
        if self.autoid(tid) < at_least:
            self._set_int(_AUTOID_PREFIX + b"%08d" % tid, at_least)

    # ---- databases ------------------------------------------------------
    def create_database(self, db: DBInfo) -> None:
        self.txn.insert(_db_key(db.id), json.dumps(db.to_dict()).encode())

    def update_database(self, db: DBInfo) -> None:
        self.txn.set(_db_key(db.id), json.dumps(db.to_dict()).encode())

    def drop_database(self, db_id: int) -> None:
        self.txn.delete(_db_key(db_id))
        for t in self.list_tables(db_id):
            self.txn.delete(_table_key(db_id, t.id))

    def get_database(self, db_id: int) -> Optional[DBInfo]:
        try:
            return DBInfo.from_dict(json.loads(self.txn.get(_db_key(db_id))))
        except KeyNotFound:
            return None

    def list_databases(self) -> List[DBInfo]:
        out = []
        for _, v in self.txn.iter_range(_DB_PREFIX, _DB_PREFIX + b"\xff"):
            out.append(DBInfo.from_dict(json.loads(v)))
        return out

    # ---- tables ---------------------------------------------------------
    def create_table(self, db_id: int, tbl: TableInfo) -> None:
        self.txn.insert(_table_key(db_id, tbl.id),
                        json.dumps(tbl.to_dict()).encode())

    def update_table(self, db_id: int, tbl: TableInfo) -> None:
        self.txn.set(_table_key(db_id, tbl.id),
                     json.dumps(tbl.to_dict()).encode())

    def drop_table(self, db_id: int, tid: int) -> None:
        self.txn.delete(_table_key(db_id, tid))

    def get_table(self, db_id: int, tid: int) -> Optional[TableInfo]:
        try:
            return TableInfo.from_dict(
                json.loads(self.txn.get(_table_key(db_id, tid))))
        except KeyNotFound:
            return None

    def list_tables(self, db_id: int) -> List[TableInfo]:
        p = _TABLE_PREFIX + b"%08d:" % db_id
        out = []
        for _, v in self.txn.iter_range(p, p + b"\xff"):
            out.append(TableInfo.from_dict(json.loads(v)))
        return out

    # ---- DDL job queues (reference: meta.go:462 EnQueueDDLJob etc.) -----
    def _load_queue(self) -> List[Job]:
        try:
            raw = json.loads(self.txn.get(_JOB_QUEUE_KEY))
        except KeyNotFound:
            return []
        return [Job.from_json(j) for j in raw]

    def _store_queue(self, jobs: List[Job]) -> None:
        self.txn.set(_JOB_QUEUE_KEY,
                     json.dumps([j.to_json() for j in jobs]).encode())

    def enqueue_job(self, job: Job) -> None:
        q = self._load_queue()
        q.append(job)
        self._store_queue(q)

    def first_job(self) -> Optional[Job]:
        q = self._load_queue()
        return q[0] if q else None

    def update_job(self, job: Job) -> None:
        q = self._load_queue()
        for i, j in enumerate(q):
            if j.id == job.id:
                q[i] = job
                self._store_queue(q)
                return
        raise KeyNotFound(f"job {job.id} not in queue")

    def pop_job(self, job_id: int) -> None:
        q = [j for j in self._load_queue() if j.id != job_id]
        self._store_queue(q)

    def queue_length(self) -> int:
        return len(self._load_queue())

    def add_history_job(self, job: Job) -> None:
        self.txn.set(_JOB_HISTORY_PREFIX + b"%016d" % job.id,
                     job.to_json().encode())

    def get_history_job(self, job_id: int) -> Optional[Job]:
        try:
            return Job.from_json(
                self.txn.get(_JOB_HISTORY_PREFIX + b"%016d" % job_id).decode())
        except KeyNotFound:
            return None

    def history_jobs(self) -> List[Job]:
        out = []
        for _, v in self.txn.iter_range(_JOB_HISTORY_PREFIX,
                                        _JOB_HISTORY_PREFIX + b"\xff"):
            out.append(Job.from_json(v.decode()))
        return out

    # ---- bootstrap flag -------------------------------------------------
    def is_bootstrapped(self) -> bool:
        return self._get_int(_BOOTSTRAP_KEY) == 1

    def set_bootstrapped(self) -> None:
        self._set_int(_BOOTSTRAP_KEY, 1)

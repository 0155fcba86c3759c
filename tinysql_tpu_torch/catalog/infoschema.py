"""Immutable schema snapshot.

Capability parity with reference infoschema/ (InfoSchema iface
infoschema.go:58-70, builder applying diffs): a versioned, immutable view of
all DBs/tables, rebuilt from meta on schema-version change.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .meta import Meta
from .model import DBInfo, TableInfo


class SchemaError(Exception):
    pass


class TableNotExist(SchemaError):
    def __init__(self, db, name):
        super().__init__(f"Table '{db}.{name}' doesn't exist")


class DatabaseNotExist(SchemaError):
    def __init__(self, name):
        super().__init__(f"Unknown database '{name}'")


class InfoSchema:
    def __init__(self, version: int, dbs: List[DBInfo],
                 tables: Dict[int, List[TableInfo]]):
        self.version = version
        self._dbs = {d.name.lower(): d for d in dbs}
        self._tables: Dict[Tuple[str, str], TableInfo] = {}
        self._by_id: Dict[int, Tuple[str, TableInfo]] = {}
        for d in dbs:
            for t in tables.get(d.id, []):
                self._tables[(d.name.lower(), t.name.lower())] = t
                self._by_id[t.id] = (d.name, t)

    # full loads with at least this many databases fetch per-db table
    # lists concurrently (reference domain.go:155-207 splitForConcurrentFetch)
    CONCURRENT_FETCH_MIN_DBS = 8

    @classmethod
    def load(cls, storage) -> "InfoSchema":
        """Full load (reference: domain.go:66-207 full load path).  Large
        catalogs split the databases across a worker pool, each worker
        reading through its own snapshot; a schema-version re-check
        guards against a DDL landing between snapshots (one consistent
        single-snapshot retry otherwise)."""
        def one_snapshot():
            txn = storage.begin()
            try:
                m = Meta(txn)
                version = m.schema_version()
                dbs = m.list_databases()
                tables = {d.id: m.list_tables(d.id) for d in dbs}
            finally:
                txn.rollback()
            return cls(version, dbs, tables)

        for _ in range(3):
            txn = storage.begin()
            m = Meta(txn)
            version = m.schema_version()
            dbs = m.list_databases()
            if len(dbs) < cls.CONCURRENT_FETCH_MIN_DBS:
                # small catalog (the common case): finish in THIS snapshot
                tables = {d.id: m.list_tables(d.id) for d in dbs}
                txn.rollback()
                return cls(version, dbs, tables)
            txn.rollback()
            from concurrent.futures import ThreadPoolExecutor

            def fetch(chunk):
                t2 = storage.begin()
                try:
                    m2 = Meta(t2)
                    return {d.id: m2.list_tables(d.id) for d in chunk}
                finally:
                    t2.rollback()
            nw = min(8, len(dbs))
            tables = {}
            with ThreadPoolExecutor(max_workers=nw,
                                    thread_name_prefix="kv-schema") as ex:
                for part in ex.map(fetch,
                                   [dbs[i::nw] for i in range(nw)]):
                    tables.update(part)
            txn = storage.begin()
            v2 = Meta(txn).schema_version()
            txn.rollback()
            if v2 == version:
                return cls(version, dbs, tables)
        # version moved 3 times under the concurrent fetch (DDL storm):
        # give up on parallelism, one consistent snapshot
        return one_snapshot()

    def schema_by_name(self, name: str) -> Optional[DBInfo]:
        return self._dbs.get(name.lower())

    def schema_exists(self, name: str) -> bool:
        return name.lower() in self._dbs

    def table_by_name(self, db: str, table: str) -> TableInfo:
        t = self._tables.get((db.lower(), table.lower()))
        if t is None:
            if not self.schema_exists(db):
                raise DatabaseNotExist(db)
            raise TableNotExist(db, table)
        return t

    def table_exists(self, db: str, table: str) -> bool:
        return (db.lower(), table.lower()) in self._tables

    def table_by_id(self, tid: int) -> Optional[TableInfo]:
        hit = self._by_id.get(tid)
        return hit[1] if hit else None

    def all_schemas(self) -> List[DBInfo]:
        return list(self._dbs.values())

    def schema_tables(self, db: str) -> List[TableInfo]:
        d = self._dbs.get(db.lower())
        if d is None:
            raise DatabaseNotExist(db)
        return [t for (dbn, _), t in self._tables.items()
                if dbn == db.lower()]

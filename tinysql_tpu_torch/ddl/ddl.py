"""DDL API: statement validation + TableInfo construction + job execution.

Capability parity with reference ddl/ddl_api.go (validation + job build;
1,949 L) and the per-action impls (table.go, column.go, index.go,
schema.go).  This module runs jobs through the owner worker
(ddl/worker.py) which steps the F1 schema-state machine; every finished
job lands in the history queue for ADMIN SHOW DDL JOBS.
"""
from __future__ import annotations

from typing import List, Optional

from ..catalog.meta import Meta
from ..catalog.model import (ActionType, ColumnInfo, DBInfo, IndexColumn,
                             IndexInfo, Job, JobState, SchemaState, TableInfo)
from ..mytypes import (EvalType, FLAG_AUTO_INCREMENT, FLAG_NOT_NULL,
                       FLAG_PRI_KEY, FLAG_UNIQUE_KEY, cast_datum)
from ..parser import ast


class DDLError(Exception):
    pass


class DBExists(DDLError):
    def __init__(self, name):
        super().__init__(f"Can't create database '{name}'; database exists")


class TableExists(DDLError):
    def __init__(self, name):
        super().__init__(f"Table '{name}' already exists")


def build_table_info(stmt: ast.CreateTableStmt, alloc_id) -> TableInfo:
    """AST -> TableInfo (reference: ddl_api.go buildTableInfo)."""
    cols: List[ColumnInfo] = []
    indices: List[IndexInfo] = []
    pk_col: Optional[str] = None
    seen = set()
    for off, cd in enumerate(stmt.cols):
        lname = cd.name.lower()
        if lname in seen:
            raise DDLError(f"Duplicate column name '{cd.name}'")
        seen.add(lname)
        ft = cd.ft.clone()
        default = None
        is_unique = False
        for opt in cd.options:
            if opt.tp == "not_null":
                ft.flag |= FLAG_NOT_NULL
            elif opt.tp == "primary":
                if pk_col is not None:
                    raise DDLError("Multiple primary key defined")
                pk_col = cd.name
                ft.flag |= FLAG_PRI_KEY | FLAG_NOT_NULL
            elif opt.tp == "unique":
                is_unique = True
            elif opt.tp == "auto_increment":
                ft.flag |= FLAG_AUTO_INCREMENT
            elif opt.tp == "default":
                default = cast_datum(opt.value, ft) if opt.value is not None else None
        ci = ColumnInfo(off + 1, cd.name, off, ft, default)
        cols.append(ci)
        if is_unique:
            indices.append(IndexInfo(0, cd.name, [IndexColumn(cd.name, off)],
                                     unique=True))
    col_by_name = {c.name.lower(): c for c in cols}

    for cons in stmt.constraints:
        icols = []
        for cname, plen in cons.columns:
            c = col_by_name.get(cname.lower())
            if c is None:
                raise DDLError(f"Key column '{cname}' doesn't exist in table")
            icols.append(IndexColumn(c.name, c.offset, plen))
        if cons.tp == "primary":
            if pk_col is not None:
                raise DDLError("Multiple primary key defined")
            if len(icols) == 1:
                c = col_by_name[icols[0].name.lower()]
                c.ft.flag |= FLAG_PRI_KEY | FLAG_NOT_NULL
                pk_col = c.name
            else:
                # composite pk -> unique index named PRIMARY
                for ic in icols:
                    col_by_name[ic.name.lower()].ft.flag |= FLAG_NOT_NULL
                indices.append(IndexInfo(0, "PRIMARY", icols, unique=True,
                                         primary=True))
                pk_col = ""
        elif cons.tp == "unique":
            indices.append(IndexInfo(0, cons.name or _auto_index_name(indices, icols),
                                     icols, unique=True))
        else:
            indices.append(IndexInfo(0, cons.name or _auto_index_name(indices, icols),
                                     icols))

    # pk-as-handle only for a single integer primary key
    pk_is_handle = False
    if pk_col:
        c = col_by_name[pk_col.lower()]
        if c.ft.eval_type is EvalType.INT:
            pk_is_handle = True
        else:
            indices.append(IndexInfo(0, "PRIMARY",
                                     [IndexColumn(c.name, c.offset)],
                                     unique=True, primary=True))

    info = TableInfo(id=0, name=stmt.table.name, columns=cols,
                     indices=indices, pk_is_handle=pk_is_handle,
                     max_column_id=len(cols))
    for i, idx in enumerate(info.indices):
        idx.id = i + 1
    info.max_index_id = len(info.indices)
    return info


def _auto_index_name(indices, icols) -> str:
    base = icols[0].name
    names = {i.name.lower() for i in indices}
    if base.lower() not in names:
        return base
    k = 2
    while f"{base}_{k}".lower() in names:
        k += 1
    return f"{base}_{k}"


class DDL:
    """DDL API facade bound to a storage; runs jobs synchronously through
    the worker's state machine (reference: ddl.go:158 DDL iface + doDDLJob
    :421 enqueue-and-wait)."""

    def __init__(self, storage, owner=None):
        self.storage = storage
        from .owner import MockOwner, OwnerManager
        from .worker import DDLWorker
        # single-node default: always-owner mock (reference: owner/mock.go);
        # a Server passes a real campaigning OwnerManager
        if owner is None or owner is True:
            owner = MockOwner(storage)
        assert isinstance(owner, OwnerManager)
        self.owner = owner
        self.worker = DDLWorker(storage)

    # ---- helpers --------------------------------------------------------
    def _run_job(self, job: Job, wait_timeout_s: float = 30.0) -> Job:
        """Enqueue, then either step the state machine (this server won
        the owner campaign) or wait for the owner server to finish it
        (reference: ddl.go doDDLJob :421 enqueue-and-wait — any server
        enqueues, only the owner's worker runs)."""
        import time
        txn = self.storage.begin()
        m = Meta(txn)
        job.id = m.gen_global_id()
        m.enqueue_job(job)
        txn.commit()
        deadline = time.monotonic() + wait_timeout_s
        done = None
        while done is None:
            if self.owner.campaign():
                self.worker.run_until_done(job.id, owner=self.owner)
            txn = self.storage.begin()
            done = Meta(txn).get_history_job(job.id)
            txn.rollback()
            if done is None:
                if time.monotonic() > deadline:
                    # a job the owner is actively stepping WILL commit:
                    # keep waiting instead of reporting a false failure
                    if self._job_in_flight(job.id):
                        deadline = time.monotonic() + wait_timeout_s
                        time.sleep(0.005)  # qlint: disable=FP501 -- deadline-bounded owner-completion poll, not an RPC retry ladder
                        continue
                    self._cancel_queued(job)
                    # outcome re-check: the owner may have finished (or
                    # be unstoppably mid-flight) in the cancel window —
                    # never report 'failed' for a DDL that committed
                    txn = self.storage.begin()
                    done = Meta(txn).get_history_job(job.id)
                    txn.rollback()
                    if done is None or (
                            done.error and "timed out" in done.error):
                        raise DDLError(f"DDL job {job.id} timed out "
                                       "waiting for the owner")
                    break
                time.sleep(0.005)  # qlint: disable=FP501 -- deadline-bounded owner-completion poll, not an RPC retry ladder
        if done.error:
            raise DDLError(done.error)
        # the OWNER thread may still be inside the final syncer barrier;
        # the DDL statement must not return before every live server has
        # loaded the final schema (reference: doDDLJob returns only after
        # checkSchemaSynced — a client's next connection may land on any
        # server and must see the new object)
        txn = self.storage.begin()
        try:
            final_ver = Meta(txn).schema_version()
        finally:
            txn.rollback()
        from ..domain import wait_schema_synced
        wait_schema_synced(self.storage, final_ver,
                           timeout_s=self.worker.sync_timeout_s)
        return done

    def _job_in_flight(self, job_id: int) -> bool:
        """Has the owner started stepping this job (schema state moved
        past NONE)?  Such a job must run to completion or roll back via
        the worker — cancelling or failing it would strand intermediate
        F1 states."""
        from ..catalog.model import SchemaState
        txn = self.storage.begin()
        try:
            queued = next((j for j in Meta(txn)._load_queue()
                           if j.id == job_id), None)
        finally:
            txn.rollback()
        return (queued is not None
                and (queued.schema_state != SchemaState.NONE
                     or queued.state != JobState.NONE))

    def _cancel_queued(self, job: Job) -> None:
        """A job reported as failed must never execute later: dequeue it
        on the timeout path — but ONLY while it is still untouched
        (schema_state NONE)."""
        from ..kv.errors import KVError
        txn = self.storage.begin()
        committed = False
        try:
            m = Meta(txn)
            if m.get_history_job(job.id) is None:
                from ..catalog.model import SchemaState
                queued = next((j for j in m._load_queue()
                               if j.id == job.id), None)
                if (queued is not None
                        and queued.schema_state == SchemaState.NONE
                        and queued.state == JobState.NONE):
                    m.pop_job(job.id)
                    job.state = JobState.CANCELLED
                    job.error = "timed out waiting for the DDL owner"
                    m.add_history_job(job)
                    m.bump_schema_version()
                    txn.commit()
                    committed = True
        except KVError:
            pass  # lost a write conflict to the owner: it took the job
        finally:
            if not committed:
                try:
                    txn.rollback()
                except Exception:
                    pass

    # ---- databases ------------------------------------------------------
    def create_database(self, name: str, if_not_exists=False) -> bool:
        """Returns True when IF NOT EXISTS made this a no-op (the
        session's Note 1007 rides the authoritative check here)."""
        txn = self.storage.begin()
        m = Meta(txn)
        exists = any(d.name.lower() == name.lower() for d in m.list_databases())
        txn.rollback()
        if exists:
            if if_not_exists:
                return True
            raise DBExists(name)
        self._run_job(Job(0, ActionType.CREATE_SCHEMA, 0, 0, args=[name]))
        return False

    def drop_database(self, name: str, if_exists=False) -> bool:
        """True when IF EXISTS made this a no-op (session Note 1008)."""
        db_id = self._db_id(name)
        if db_id is None:
            if if_exists:
                return True
            raise DDLError(f"Can't drop database '{name}'; database doesn't exist")
        self._run_job(Job(0, ActionType.DROP_SCHEMA, db_id, 0))
        return False

    def _db_id(self, name: str) -> Optional[int]:
        txn = self.storage.begin()
        m = Meta(txn)
        hit = next((d.id for d in m.list_databases()
                    if d.name.lower() == name.lower()), None)
        txn.rollback()
        return hit

    def _table(self, db_id: int, name: str) -> Optional[TableInfo]:
        txn = self.storage.begin()
        m = Meta(txn)
        hit = next((t for t in m.list_tables(db_id)
                    if t.name.lower() == name.lower()), None)
        txn.rollback()
        return hit

    def _require_db(self, name: str) -> int:
        db_id = self._db_id(name)
        if db_id is None:
            raise DDLError(f"Unknown database '{name}'")
        return db_id

    def _require_table(self, db_id: int, name: str) -> TableInfo:
        t = self._table(db_id, name)
        if t is None:
            raise DDLError(f"Table '{name}' doesn't exist")
        return t

    # ---- tables ---------------------------------------------------------
    def create_table(self, db_name: str, stmt: ast.CreateTableStmt) -> bool:
        """True when IF NOT EXISTS made this a no-op (session Note 1050)."""
        db_id = self._require_db(db_name)
        if self._table(db_id, stmt.table.name) is not None:
            if stmt.if_not_exists:
                return True
            raise TableExists(stmt.table.name)
        info = build_table_info(stmt, None)
        self._run_job(Job(0, ActionType.CREATE_TABLE, db_id, 0,
                          args=[info.to_dict()]))
        return False

    def drop_table(self, db_name: str, table: str, if_exists=False) -> bool:
        """True when IF EXISTS made this a no-op (session Note 1051)."""
        db_id = self._require_db(db_name)
        t = self._table(db_id, table)
        if t is None:
            if if_exists:
                return True
            raise DDLError(f"Unknown table '{table}'")
        self._run_job(Job(0, ActionType.DROP_TABLE, db_id, t.id))
        return False

    def truncate_table(self, db_name: str, table: str) -> None:
        db_id = self._require_db(db_name)
        t = self._require_table(db_id, table)
        self._run_job(Job(0, ActionType.TRUNCATE_TABLE, db_id, t.id))

    # ---- columns --------------------------------------------------------
    def add_column(self, db_name: str, table: str, cd: ast.ColumnDef) -> None:
        db_id = self._require_db(db_name)
        t = self._require_table(db_id, table)
        if t.find_column(cd.name) is not None:
            raise DDLError(f"Duplicate column name '{cd.name}'")
        ft = cd.ft.clone()
        default = None
        for opt in cd.options:
            if opt.tp == "not_null":
                ft.flag |= FLAG_NOT_NULL
            elif opt.tp == "default":
                default = opt.value
            elif opt.tp in ("primary", "unique", "auto_increment"):
                raise DDLError(f"unsupported option {opt.tp} in ADD COLUMN")
        col = ColumnInfo(0, cd.name, 0, ft, default)
        self._run_job(Job(0, ActionType.ADD_COLUMN, db_id, t.id,
                          args=[col.to_dict()]))

    def drop_column(self, db_name: str, table: str, col_name: str) -> None:
        db_id = self._require_db(db_name)
        t = self._require_table(db_id, table)
        c = t.find_column(col_name)
        if c is None:
            raise DDLError(f"Can't DROP '{col_name}'; check that column exists")
        if len(t.public_columns()) == 1:
            raise DDLError(f"Can't delete all columns with ALTER TABLE")
        if t.pk_is_handle and (c.ft.flag & FLAG_PRI_KEY):
            raise DDLError("Unsupported drop primary key column")
        for idx in t.indices:
            if any(ic.name.lower() == col_name.lower() for ic in idx.columns):
                raise DDLError(
                    f"column '{col_name}' is covered by index '{idx.name}'; "
                    f"drop the index first")
        self._run_job(Job(0, ActionType.DROP_COLUMN, db_id, t.id,
                          args=[c.name]))

    # ---- indices --------------------------------------------------------
    def add_index(self, db_name: str, table: str, index_name: str,
                  columns: List, unique: bool) -> None:
        db_id = self._require_db(db_name)
        t = self._require_table(db_id, table)
        if index_name and t.find_index(index_name) is not None:
            raise DDLError(f"Duplicate key name '{index_name}'")
        icols = []
        for cname, plen in columns:
            c = t.find_column(cname)
            if c is None:
                raise DDLError(f"Key column '{cname}' doesn't exist in table")
            icols.append(IndexColumn(c.name, c.offset, plen))
        info = IndexInfo(0, index_name or _auto_index_name(t.indices, icols),
                         icols, unique=unique)
        self._run_job(Job(0, ActionType.ADD_INDEX, db_id, t.id,
                          args=[info.to_dict()]))

    def drop_index(self, db_name: str, table: str, index_name: str) -> None:
        db_id = self._require_db(db_name)
        t = self._require_table(db_id, table)
        if t.find_index(index_name) is None:
            raise DDLError(f"Can't DROP '{index_name}'; check that index exists")
        self._run_job(Job(0, ActionType.DROP_INDEX, db_id, t.id,
                          args=[index_name]))

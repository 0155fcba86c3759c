"""DDL worker: asynchronous-model job queue + F1 schema-state machine.

Capability parity with reference ddl/ddl_worker.go:300,427-460 (dequeue +
dispatch by ActionType, one state transition per own-txn iteration, schema
version bump per step), ddl/column.go (add/drop column state ladders; the
course's drop-column task at column.go:216), ddl/index.go + ddl/reorg.go
(add-index backfill in checkpointed batches), ddl/rollingback.go (unique
violation rolls the index add back), ddl/schema.go, ddl/table.go.

Each state step commits its own meta txn and bumps the schema version, so
concurrent sessions never observe a jump of more than one state — the F1
invariant that makes online DDL safe with lease-based schema caches.
"""
from __future__ import annotations

from typing import List, Optional

from ..catalog.meta import Meta
from ..catalog.model import (ActionType, ColumnInfo, DBInfo, IndexInfo, Job,
                             JobState, SchemaState, TableInfo)
from ..catalog.table import DuplicateKeyError, Index, Table
from ..codec import tablecodec
from ..kv.errors import KVError, KeyNotFound
from ..utils import failpoint

REORG_BATCH = 256  # reference: ddl variable defaultReorgBatchSize spirit


class DDLWorker:
    """Synchronous owner worker: steps the first queued job until history.
    (Single-process build: the etcd owner election collapses to local
    ownership; owner/manager.go's mock owner is the model.)"""

    def __init__(self, storage, sync_timeout_s: float = 1.0):
        self.storage = storage
        self.sync_timeout_s = sync_timeout_s

    # ---- main loop ------------------------------------------------------
    def run_until_done(self, job_id: int, max_steps: int = 10_000,
                       owner=None) -> None:
        """Step first-queued jobs until `job_id` reaches history.  With
        an `owner` manager, each step re-campaigns (renewing the lease —
        a long backfill must not silently lose ownership mid-job); lost
        ownership returns control to the caller's wait loop."""
        for _ in range(max_steps):
            if owner is not None and not owner.campaign():
                return  # ownership lost/taken: another worker steps now
            txn = self.storage.begin()
            m = Meta(txn)
            if m.get_history_job(job_id) is not None:
                txn.rollback()
                return
            job = m.first_job()
            if job is None:
                txn.rollback()
                return
            try:
                finished = self._run_one_step(m, job)
                if finished:
                    m.pop_job(job.id)
                    job.state = (JobState.CANCELLED if job.error
                                 else JobState.SYNCED)
                    m.add_history_job(job)
                ver = m.bump_schema_version()
                txn.commit()
                # syncer barrier (reference: ddl/util/syncer.go via
                # ddl_worker.go waitSchemaSynced): every registered
                # server domain must load this version before the NEXT
                # state transition — the F1 "at most one state apart"
                # invariant across servers; timeout falls through to the
                # commit-time schema validator as the backstop
                from ..domain import wait_schema_synced
                wait_schema_synced(self.storage, ver,
                                   timeout_s=self.sync_timeout_s)
            except KVError:
                txn.rollback()
                continue  # retry the step
            except Exception as e:  # job-level failure -> record + finish
                txn.rollback()
                txn = self.storage.begin()
                m = Meta(txn)
                job.error = str(e)
                job.state = JobState.CANCELLED
                m.pop_job(job.id)
                m.add_history_job(job)
                m.bump_schema_version()
                txn.commit()
        raise RuntimeError(f"DDL job {job_id} did not converge")

    def run_pending(self, owner=None, max_steps: int = 10_000) -> None:
        """Owner background duty (reference: ddl_worker.go:112 start loop):
        drain whatever is queued — jobs enqueued by OTHER servers must
        not wait for the owner's lease to lapse."""
        for _ in range(max_steps):
            if owner is not None and not owner.campaign():
                return
            txn = self.storage.begin()
            m = Meta(txn)
            job = m.first_job()
            txn.rollback()
            if job is None:
                return
            self.run_until_done(job.id, owner=owner)

    # ---- dispatch (reference: ddl_worker.go:427 runDDLJob) -------------
    def _run_one_step(self, m: Meta, job: Job) -> bool:
        failpoint.inject("ddlStepError")
        handler = {
            ActionType.CREATE_SCHEMA: self._on_create_schema,
            ActionType.DROP_SCHEMA: self._on_drop_schema,
            ActionType.CREATE_TABLE: self._on_create_table,
            ActionType.DROP_TABLE: self._on_drop_table,
            ActionType.TRUNCATE_TABLE: self._on_truncate_table,
            ActionType.ADD_COLUMN: self._on_add_column,
            ActionType.DROP_COLUMN: self._on_drop_column,
            ActionType.ADD_INDEX: self._on_add_index,
            ActionType.DROP_INDEX: self._on_drop_index,
        }[job.tp]
        finished = handler(m, job)
        if not finished:
            m.update_job(job)
        return finished

    # ---- schema ---------------------------------------------------------
    def _on_create_schema(self, m: Meta, job: Job) -> bool:
        db = DBInfo(m.gen_global_id(), job.args[0])
        m.create_database(db)
        job.schema_id = db.id
        job.state = JobState.DONE
        return True

    def _on_drop_schema(self, m: Meta, job: Job) -> bool:
        db = m.get_database(job.schema_id)
        if db is None:
            job.state = JobState.DONE
            return True
        if db.state == SchemaState.PUBLIC:
            db.state = SchemaState.WRITE_ONLY
            m.update_database(db)
            job.schema_state = db.state
            return False
        if db.state == SchemaState.WRITE_ONLY:
            db.state = SchemaState.DELETE_ONLY
            m.update_database(db)
            job.schema_state = db.state
            return False
        # final: drop tables' data + meta
        for t in m.list_tables(db.id):
            self._delete_table_data(t)
        m.drop_database(db.id)
        job.state = JobState.DONE
        return True

    # ---- tables ---------------------------------------------------------
    def _on_create_table(self, m: Meta, job: Job) -> bool:
        info = TableInfo.from_dict(job.args[0])
        info.id = m.gen_global_id()
        info.state = SchemaState.PUBLIC
        m.create_table(job.schema_id, info)
        job.table_id = info.id
        job.state = JobState.DONE
        return True

    def _on_drop_table(self, m: Meta, job: Job) -> bool:
        t = m.get_table(job.schema_id, job.table_id)
        if t is None:
            job.state = JobState.DONE
            return True
        if t.state == SchemaState.PUBLIC:
            t.state = SchemaState.WRITE_ONLY
        elif t.state == SchemaState.WRITE_ONLY:
            t.state = SchemaState.DELETE_ONLY
        else:
            self._delete_table_data(t)
            m.drop_table(job.schema_id, t.id)
            job.state = JobState.DONE
            return True
        m.update_table(job.schema_id, t)
        job.schema_state = t.state
        return False

    def _on_truncate_table(self, m: Meta, job: Job) -> bool:
        t = m.get_table(job.schema_id, job.table_id)
        self._delete_table_data(t)
        old_id = t.id
        m.drop_table(job.schema_id, old_id)
        t.id = m.gen_global_id()
        m.create_table(job.schema_id, t)
        job.args = [old_id, t.id]
        job.state = JobState.DONE
        return True

    def _delete_table_data(self, t: TableInfo) -> None:
        """Synchronous delete-range (reference defers to GC delete-ranges;
        in-proc we clear eagerly)."""
        txn = self.storage.begin()
        lo = tablecodec.encode_table_prefix(t.id)
        hi = lo + b"\xff" * 20
        for k, _ in list(txn.iter_range(lo, hi)):
            txn.delete(k)
        txn.commit()
        from ..statistics.table_stats import drop_stats
        drop_stats(self.storage, t.id)

    # ---- columns (reference: ddl/column.go; course stub :216) ----------
    def _on_add_column(self, m: Meta, job: Job) -> bool:
        t = m.get_table(job.schema_id, job.table_id)
        col = t.find_column(ColumnInfo.from_dict(job.args[0]).name)
        if col is None:
            col = ColumnInfo.from_dict(job.args[0])
            t.max_column_id += 1
            col.id = t.max_column_id
            col.offset = len(t.columns)
            col.state = SchemaState.DELETE_ONLY
            t.columns.append(col)
        elif col.state == SchemaState.DELETE_ONLY:
            col.state = SchemaState.WRITE_ONLY
        elif col.state == SchemaState.WRITE_ONLY:
            col.state = SchemaState.WRITE_REORG
        else:
            # no backfill needed: absent values read as the default
            # (rowcodec fills defaults on decode)
            col.state = SchemaState.PUBLIC
            m.update_table(job.schema_id, t)
            job.state = JobState.DONE
            return True
        m.update_table(job.schema_id, t)
        job.schema_state = col.state
        return False

    def _on_drop_column(self, m: Meta, job: Job) -> bool:
        t = m.get_table(job.schema_id, job.table_id)
        col = t.find_column(job.args[0])
        if col is None:
            job.state = JobState.DONE
            return True
        if col.state == SchemaState.PUBLIC:
            col.state = SchemaState.WRITE_ONLY
        elif col.state == SchemaState.WRITE_ONLY:
            col.state = SchemaState.DELETE_ONLY
        elif col.state == SchemaState.DELETE_ONLY:
            col.state = SchemaState.WRITE_REORG
        else:
            t.columns.remove(col)
            for i, c in enumerate(sorted(t.columns, key=lambda c: c.offset)):
                c.offset = i
            t.columns.sort(key=lambda c: c.offset)
            m.update_table(job.schema_id, t)
            job.state = JobState.DONE
            return True
        m.update_table(job.schema_id, t)
        job.schema_state = col.state
        return False

    # ---- indices (reference: ddl/index.go + reorg.go backfill) ---------
    def _on_add_index(self, m: Meta, job: Job) -> bool:
        t = m.get_table(job.schema_id, job.table_id)
        want = IndexInfo.from_dict(job.args[0])
        idx = t.find_index(want.name)
        if job.state == JobState.ROLLINGBACK:
            return self._rollback_add_index(m, job, t, idx)
        if idx is None:
            idx = IndexInfo.from_dict(job.args[0])
            t.max_index_id += 1
            idx.id = t.max_index_id
            idx.state = SchemaState.DELETE_ONLY
            t.indices.append(idx)
        elif idx.state == SchemaState.DELETE_ONLY:
            idx.state = SchemaState.WRITE_ONLY
        elif idx.state == SchemaState.WRITE_ONLY:
            idx.state = SchemaState.WRITE_REORG
            job.reorg_handle = 0
        elif idx.state == SchemaState.WRITE_REORG:
            try:
                done = self._backfill_batch(t, idx, job)
            except DuplicateKeyError as e:
                job.state = JobState.ROLLINGBACK
                job.error = str(e)
                m.update_job(job)
                return False
            if not done:
                m.update_job(job)
                return False
            idx.state = SchemaState.PUBLIC
            m.update_table(job.schema_id, t)
            job.state = JobState.DONE
            return True
        m.update_table(job.schema_id, t)
        job.schema_state = idx.state
        return False

    def _rollback_add_index(self, m: Meta, job: Job, t: TableInfo,
                            idx: Optional[IndexInfo]) -> bool:
        """reference: rollingback.go — walk states back, drop entries."""
        if idx is None:
            job.error = job.error or "add index rolled back"
            return True
        if idx.state in (SchemaState.WRITE_REORG, SchemaState.WRITE_ONLY):
            idx.state = SchemaState.DELETE_ONLY
            m.update_table(job.schema_id, t)
            return False
        self._delete_index_data(t, idx)
        t.indices.remove(idx)
        m.update_table(job.schema_id, t)
        job.error = job.error or "add index rolled back"
        return True

    def _backfill_batch(self, t: TableInfo, idx_info: IndexInfo,
                        job: Job) -> bool:
        """One checkpointed backfill batch in its own txn (reference:
        reorg.go backfill loop; job.reorg_handle is the crash-resume
        checkpoint).  Returns True when the scan is exhausted."""
        failpoint.inject("reorgBatchError")
        txn = self.storage.begin()
        tbl = Table(t)
        idx = Index(tbl, idx_info)
        count = 0
        last_handle = None
        start = job.reorg_handle + 1 if job.reorg_handle else None
        for handle, row in tbl.iter_records(txn, start_handle=start):
            k, v = idx.key(row, handle)
            if idx_info.unique:
                existing = idx.exists_conflict(txn, row)
                if existing is not None and existing != handle:
                    txn.rollback()
                    raise DuplicateKeyError(t.name, idx_info.name,
                                            idx._index_values(row))
            txn.set(k, v)
            last_handle = handle
            count += 1
            if count >= REORG_BATCH:
                break
        txn.commit()
        job.row_count += count
        if last_handle is not None:
            job.reorg_handle = last_handle
        return count < REORG_BATCH

    def _on_drop_index(self, m: Meta, job: Job) -> bool:
        t = m.get_table(job.schema_id, job.table_id)
        idx = t.find_index(job.args[0])
        if idx is None:
            job.state = JobState.DONE
            return True
        if idx.state == SchemaState.PUBLIC:
            idx.state = SchemaState.WRITE_ONLY
        elif idx.state == SchemaState.WRITE_ONLY:
            idx.state = SchemaState.DELETE_ONLY
        else:
            self._delete_index_data(t, idx)
            t.indices.remove(idx)
            m.update_table(job.schema_id, t)
            job.state = JobState.DONE
            return True
        m.update_table(job.schema_id, t)
        job.schema_state = idx.state
        return False

    def _delete_index_data(self, t: TableInfo, idx: IndexInfo) -> None:
        txn = self.storage.begin()
        lo, hi = tablecodec.index_range(t.id, idx.id)
        for k, _ in list(txn.iter_range(lo, hi)):
            txn.delete(k)
        txn.commit()

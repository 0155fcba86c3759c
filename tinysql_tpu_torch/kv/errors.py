"""KV error taxonomy (reference: kv/error.go, store/tikv error surface)."""
from __future__ import annotations


class KVError(Exception):
    pass


class KeyNotFound(KVError):
    pass


class KeyExists(KVError):
    """Duplicate key on prewrite/insert (reference: kv.ErrKeyExists)."""
    def __init__(self, key: bytes):
        super().__init__(f"key already exists: {key!r}")
        self.key = key


class KeyIsLocked(KVError):
    """Encountered another txn's lock (reference: kvrpcpb KeyError.Locked)."""
    def __init__(self, key: bytes, primary: bytes, start_ts: int, ttl: int):
        super().__init__(f"key is locked: {key!r} by txn {start_ts}")
        self.key = key
        self.primary = primary
        self.lock_ts = start_ts
        self.ttl = ttl


class WriteConflict(KVError):
    """A newer commit landed after our start_ts (reference: ErrWriteConflict)."""
    def __init__(self, key: bytes, start_ts: int, conflict_ts: int):
        super().__init__(
            f"write conflict on {key!r}: start_ts={start_ts} conflict_commit_ts={conflict_ts}")
        self.key = key
        self.start_ts = start_ts
        self.conflict_ts = conflict_ts


class TxnAborted(KVError):
    """Commit arrived for a rolled-back txn (reference: ErrTxnAborted)."""


class RetryableError(KVError):
    """Transaction should be retried by the session layer."""


class RegionError(KVError):
    """Routing error — retry after refreshing the region cache
    (reference: errorpb region errors; region_request.go)."""
    def __init__(self, kind: str, region_id: int = 0):
        super().__init__(f"region error: {kind} (region {region_id})")
        self.kind = kind
        self.region_id = region_id


class BackoffExceeded(KVError):
    """Retry budget exhausted (reference: backoff.go maxSleep)."""


class UndeterminedError(KVError):
    """Commit outcome unknown (error on primary-commit RPC) —
    reference: 2pc.go:417-428."""


class WalError(KVError):
    """Write-ahead-log append/fsync failure — the mutation it was meant
    to journal is NOT applied (the store never diverges ahead of a log
    it could not write)."""


class CheckpointError(WalError):
    """A checkpoint attempt failed — counted and retried on the next
    trigger; the previous checkpoint + the unrotated log remain the
    recovery source, so this is never fatal to the store."""


class TaskCancelled(KVError):
    """A cooperative cancel (early close of a scatter-gather, statement
    kill) interrupted this task's retry loop — never user-visible: the
    canceller discards the task's result."""


class SchemaOutdated(RetryableError):
    """Schema changed during txn; lease check failed
    (reference: domain/schema_validator.go)."""

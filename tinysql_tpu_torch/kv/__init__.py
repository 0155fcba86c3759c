"""Transactional KV layer (reference: kv/, store/tikv/, store/mockstore/)."""
from .errors import (KVError, KeyNotFound, KeyExists, KeyIsLocked,
                     WriteConflict, TxnAborted, RetryableError, RegionError,
                     BackoffExceeded, UndeterminedError, SchemaOutdated,
                     WalError, CheckpointError)
from .wal import WriteAheadLog
from .oracle import Oracle
from .memdb import MemDB, UnionStore, TOMBSTONE
from .mvcc import MVCCStore, Mutation, OP_PUT, OP_DEL, OP_INSERT
from .cluster import Cluster, Region, Store
from .rpc import RPCClient, RegionCache, RegionCtx
from .backoff import Backoffer
from .txn import (Transaction, Snapshot, TwoPhaseCommitter, LockResolver,
                  TiKVStorage, new_mock_storage)
from .rawkv import RawKVClient, RawStore
from .range_task import RangeTaskRunner, RangeTaskStat

__all__ = [
    "KVError", "KeyNotFound", "KeyExists", "KeyIsLocked", "WriteConflict",
    "TxnAborted", "RetryableError", "RegionError", "BackoffExceeded",
    "UndeterminedError", "SchemaOutdated", "WalError", "CheckpointError",
    "WriteAheadLog",
    "Oracle", "MemDB", "UnionStore", "TOMBSTONE",
    "MVCCStore", "Mutation", "OP_PUT", "OP_DEL", "OP_INSERT",
    "Cluster", "Region", "Store", "RPCClient", "RegionCache", "RegionCtx",
    "Backoffer", "Transaction", "Snapshot", "TwoPhaseCommitter",
    "LockResolver", "TiKVStorage", "new_mock_storage",
    "RawKVClient", "RawStore", "RangeTaskRunner", "RangeTaskStat",
]

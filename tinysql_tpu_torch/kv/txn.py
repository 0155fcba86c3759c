"""Client-side transaction stack: snapshot reads, lock resolution,
Percolator two-phase commit.

Capability parity with reference store/tikv/: snapshot.go (point get w/
lock-encounter→resolve loop), scan.go, lock_resolver.go:37-335 (txn-status
check, secondary resolution, resolved-txn cache), 2pc.go (mutation
collection :115, primary selection :211, region-batched parallel
prewrite/commit/cleanup :247-543, undetermined-error tracking :417),
txn.go (commit entry).
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from ..utils import failpoint
from . import backoff as bo
from .backoff import Backoffer
from .cluster import Region
from .errors import (BackoffExceeded, KeyExists, KeyIsLocked, KeyNotFound, KVError,
                     RegionError, TxnAborted, UndeterminedError, WriteConflict)
from .memdb import TOMBSTONE, MemDB, UnionStore
from .mvcc import Mutation, OP_DEL, OP_INSERT, OP_PUT
from .oracle import Oracle
from .rpc import RegionCache, RegionCtx, RPCClient

DEFAULT_LOCK_TTL_MS = 3000
MAX_TXN_ENTRIES = 300_000      # reference: kv/kv.go:99-103 size limits
COMMITTER_CONCURRENCY = 16     # reference: 2pc.go rate limit


class LockResolver:
    """reference: lock_resolver.go — decide a blocking txn's fate via its
    primary lock, then resolve the encountered lock."""

    def __init__(self, client: RPCClient, cache: RegionCache, oracle: Oracle,
                 storage=None):
        self.client = client
        self.cache = cache
        self.oracle = oracle
        self.storage = storage  # for columnar invalidation on resolve-commit
        self._resolved: Dict[int, int] = {}  # start_ts -> commit_ts (0=rolled back)
        self._mu = threading.Lock()

    def resolve(self, boer: Backoffer, lock: KeyIsLocked) -> bool:
        """Try to resolve; returns True if the caller may retry immediately,
        False if it must back off (lock still alive)."""
        with self._mu:
            known = self._resolved.get(lock.lock_ts)
        if known is None:
            expired = self.oracle.is_expired(lock.lock_ts, lock.ttl)
            try:
                commit_ts, committed = self._check_txn_status(
                    boer, lock.primary, lock.lock_ts, expired)
            except KeyIsLocked:
                return False  # primary lock alive; wait for TTL
            known = commit_ts if committed else 0
            with self._mu:
                self._resolved[lock.lock_ts] = known
                if len(self._resolved) > 4096:
                    self._resolved.pop(next(iter(self._resolved)))
        self._send_resolve(boer, lock.key, lock.lock_ts, known)
        if known > 0 and self.storage is not None:
            # resolving to COMMITTED makes a crashed writer's data visible:
            # invalidate that table's columnar replica (the crashed
            # committer never ran its own bump)
            from ..columnar.store import bump_table_version
            from ..codec.tablecodec import decode_table_id
            for k in (lock.key, lock.primary):
                if k[:1] == b"t" and len(k) >= 9:
                    try:
                        bump_table_version(self.storage, decode_table_id(k))
                    except ValueError:
                        pass
        return True

    def _check_txn_status(self, boer: Backoffer, primary: bytes,
                          lock_ts: int, expired: bool) -> Tuple[int, bool]:
        while True:
            r = self.cache.locate_key(primary)
            try:
                return self.client.kv_check_txn_status(
                    RegionCtx(r.id, r.epoch), primary, lock_ts, expired)
            except RegionError as e:
                self.cache.invalidate(r.id)
                boer.backoff(bo.BO_REGION_MISS, e)

    def _send_resolve(self, boer: Backoffer, key: bytes, start_ts: int,
                      commit_ts: int) -> None:
        while True:
            r = self.cache.locate_key(key)
            try:
                self.client.kv_resolve_lock(
                    RegionCtx(r.id, r.epoch), key, start_ts, commit_ts)
                return
            except RegionError as e:
                self.cache.invalidate(r.id)
                boer.backoff(bo.BO_REGION_MISS, e)


class Snapshot:
    """MVCC snapshot reads at a fixed ts (reference: snapshot.go:81-166)."""

    def __init__(self, storage: "TiKVStorage", ts: int):
        self.storage = storage
        self.ts = ts

    # -- point get -------------------------------------------------------
    def get(self, key: bytes) -> bytes:
        boer = Backoffer(bo.GET_MAX_BACKOFF)
        while True:
            r = self.storage.cache.locate_key(key)
            try:
                return self.storage.client.kv_get(
                    RegionCtx(r.id, r.epoch), key, self.ts)
            except RegionError as e:
                self.storage.cache.invalidate(r.id)
                boer.backoff(bo.BO_REGION_MISS, e)
            except KeyIsLocked as lk:
                if not self.storage.resolver.resolve(boer, lk):
                    boer.backoff(bo.BO_TXN_LOCK_FAST, lk)

    def batch_get(self, keys: List[bytes]) -> Dict[bytes, bytes]:
        """Region-batched point gets: O(regions) RPCs, not O(keys)
        (reference: snapshot.go BatchGet)."""
        out: Dict[bytes, bytes] = {}
        boer = Backoffer(bo.GET_MAX_BACKOFF)
        pending = list(dict.fromkeys(keys))
        while pending:
            retry: List[bytes] = []
            for r, ks in self.storage.cache.group_keys_by_region(pending):
                try:
                    for k, v in self.storage.client.kv_batch_get(
                            RegionCtx(r.id, r.epoch), ks, self.ts):
                        out[k] = v
                except RegionError as e:
                    self.storage.cache.invalidate(r.id)
                    boer.backoff(bo.BO_REGION_MISS, e)
                    retry.extend(ks)
                except KeyIsLocked as lk:
                    if not self.storage.resolver.resolve(boer, lk):
                        boer.backoff(bo.BO_TXN_LOCK_FAST, lk)
                    retry.extend(ks)
            pending = retry
        return out

    # -- range scan ------------------------------------------------------
    def iter_range(self, start: Optional[bytes],
                   end: Optional[bytes]) -> Iterator[Tuple[bytes, bytes]]:
        start = start or b""
        end = end if end is not None else b"\xff" * 64
        boer = Backoffer(bo.SCAN_MAX_BACKOFF)
        cur = start
        while cur < end:
            r = self.storage.cache.locate_key(cur)
            sub_end = min(end, r.end)
            try:
                batch = self.storage.client.kv_scan(
                    RegionCtx(r.id, r.epoch), cur, sub_end, self.ts)
            except RegionError as e:
                self.storage.cache.invalidate(r.id)
                boer.backoff(bo.BO_REGION_MISS, e)
                continue
            except KeyIsLocked as lk:
                if not self.storage.resolver.resolve(boer, lk):
                    boer.backoff(bo.BO_TXN_LOCK_FAST, lk)
                continue
            yield from batch
            cur = sub_end


class TwoPhaseCommitter:
    """reference: 2pc.go twoPhaseCommitter."""

    def __init__(self, txn: "Transaction"):
        self.txn = txn
        self.storage = txn.storage
        self.mutations: List[Mutation] = []
        self.start_ts = txn.start_ts
        self.commit_ts = 0
        self.primary: Optional[bytes] = None
        self.undetermined = False
        self._init_mutations()

    def _init_mutations(self) -> None:
        """Walk the membuffer (reference: 2pc.go:115 initKeysAndMutations)."""
        for k, v in self.txn.us.buffer.items():
            if v == TOMBSTONE:
                self.mutations.append(Mutation(OP_DEL, k))
            elif k in self.txn.presume_not_exists:
                self.mutations.append(Mutation(OP_INSERT, k, v))
            else:
                self.mutations.append(Mutation(OP_PUT, k, v))
        if len(self.mutations) > MAX_TXN_ENTRIES:
            raise KVError(f"transaction too large: {len(self.mutations)} entries")
        if self.mutations:
            # primary = first mutated key (reference: 2pc.go:211)
            self.primary = self.mutations[0].key

    # ---- region batching ------------------------------------------------
    def _group_mutations(self) -> List[Tuple[Region, List[Mutation]]]:
        return self.storage.cache.group_by_region(self.mutations,
                                                  lambda m: m.key)

    def _run_batches(self, action: Callable, batches, primary_first: bool) -> None:
        """Bounded-parallel per-region execution (reference: 2pc.go:672-721);
        the primary's batch runs first and alone — it is the durability
        point (reference: 2pc.go:429-500)."""
        if not batches:
            return
        if primary_first:
            prim = [b for b in batches
                    if any(self._key_of(x) == self.primary for x in b[1])]
            rest = [b for b in batches if b not in prim]
            for b in prim:
                action(b)
            batches = rest
        if not batches:
            return
        if len(batches) == 1:
            action(batches[0])
            return
        with ThreadPoolExecutor(max_workers=COMMITTER_CONCURRENCY,
                                thread_name_prefix="kv-commit") as ex:
            futures = [ex.submit(action, b) for b in batches]
            for f in futures:
                f.result()

    @staticmethod
    def _key_of(x) -> bytes:
        return x.key if isinstance(x, Mutation) else x

    # ---- phases ---------------------------------------------------------
    def prewrite(self) -> None:
        boer = Backoffer(bo.PREWRITE_MAX_BACKOFF)

        def one(batch: Tuple[Region, List[Mutation]]) -> None:
            r, muts = batch
            b = boer.fork()
            while True:
                try:
                    self.storage.client.kv_prewrite(
                        RegionCtx(r.id, r.epoch), muts, self.primary,
                        self.start_ts, DEFAULT_LOCK_TTL_MS)
                    return
                except RegionError as e:
                    self.storage.cache.invalidate(r.id)
                    b.backoff(bo.BO_REGION_MISS, e)
                    # re-split this batch by fresh regions
                    for sub in self._regroup(muts):
                        one(sub)
                    return
                except KeyIsLocked as lk:
                    if not self.storage.resolver.resolve(b, lk):
                        b.backoff(bo.BO_TXN_LOCK, lk)
                except KeyExists as ke:
                    raise self.txn.dup_info.get(ke.key, ke)

        self._run_batches(one, self._group_mutations(), primary_first=False)

    def _regroup(self, muts: List[Mutation]):
        return self.storage.cache.group_by_region(muts, lambda m: m.key)

    def commit_keys(self) -> None:
        keys = [m.key for m in self.mutations]
        groups = self.storage.cache.group_keys_by_region(keys)
        # NOT interruptible: the primary batch runs first, and once it
        # committed the txn is durable — a statement kill aborting a
        # secondary retry here would report 1317 for a COMMITTED txn and
        # skip the columnar invalidation (kills land before/after the
        # commit phase instead, via the executor checks and prewrite)
        boer = Backoffer(bo.COMMIT_MAX_BACKOFF, interruptible=False)

        def one(batch: Tuple[Region, List[bytes]]) -> None:
            r, ks = batch
            b = boer.fork()
            is_primary = self.primary in ks
            while True:
                try:
                    failpoint.inject("commitPrimaryError" if is_primary
                                     else "commitSecondaryError")
                    self.storage.client.kv_commit(
                        RegionCtx(r.id, r.epoch), ks, self.start_ts, self.commit_ts)
                    return
                except RegionError as e:
                    self.storage.cache.invalidate(r.id)
                    try:
                        b.backoff(bo.BO_REGION_MISS, e)
                    except BackoffExceeded:
                        if is_primary:
                            self.undetermined = True
                        raise
                    for sub in self.storage.cache.group_keys_by_region(ks):
                        one(sub)
                    return
                except TxnAborted:
                    raise
                except Exception as e:
                    if is_primary:
                        # commit RPC failure on the primary = outcome unknown
                        # (reference: 2pc.go:417-428)
                        self.undetermined = True
                        raise UndeterminedError(str(e)) from e
                    # secondary failures are tolerated: the txn is durable
                    # once the primary committed; leftover locks are resolved
                    # by later readers (reference: 2pc.go commits secondaries
                    # async and drops errors)
                    return

        self._run_batches(one, groups, primary_first=True)

    def cleanup(self) -> None:
        """Async rollback on failure (reference: 2pc.go cleanupKeys)."""
        keys = [m.key for m in self.mutations]
        try:
            for r, ks in self.storage.cache.group_keys_by_region(keys):
                try:
                    self.storage.client.kv_rollback(
                        RegionCtx(r.id, r.epoch), ks, self.start_ts)
                except RegionError:
                    self.storage.cache.invalidate(r.id)
        except Exception:
            pass  # best-effort; lock TTL + resolver recover the rest

    def execute(self) -> None:
        """reference: 2pc.go:545 execute."""
        if not self.mutations:
            return
        committed = False
        try:
            self.prewrite()
            # schema re-check at the COMMIT timestamp, before the point of
            # no return (2pc.go:633): a DDL landing between prewrite and
            # commit_ts logically precedes this txn and must abort it
            self.commit_ts = self.storage.oracle.get_timestamp()
            if self.txn.schema_check is not None:
                self.txn.schema_check(self.commit_ts)
            failpoint.inject("beforeCommit")
            self.commit_keys()
            committed = True
        finally:
            if committed or self.undetermined:
                # undetermined: the primary may have committed (the resolver
                # will finish the job) — invalidating is safe either way,
                # NOT invalidating would leave a stale columnar replica
                self._bump_columnar_versions()
            else:
                self.cleanup()

    def _bump_columnar_versions(self) -> None:
        """Invalidate columnar replicas of every table this txn wrote
        (columnar/store.py data-version protocol)."""
        from ..columnar.store import bump_table_version
        tids = set()
        for m in self.mutations:
            if m.key[:1] == b"t" and len(m.key) >= 9:
                try:
                    from ..codec.tablecodec import decode_table_id
                    tids.add(decode_table_id(m.key))
                except ValueError:
                    pass
        for tid in tids:
            bump_table_version(self.storage, tid)


class Transaction:
    """reference: store/tikv/txn.go tikvTxn + kv.Transaction iface
    (kv/kv.go:105-310)."""

    def __init__(self, storage: "TiKVStorage", start_ts: int):
        self.storage = storage
        self.start_ts = start_ts
        self.snapshot = Snapshot(storage, start_ts)
        self.us = UnionStore(self.snapshot)
        self.presume_not_exists: set = set()
        # key -> exception to raise on duplicate, so the SQL layer's
        # dup-entry message survives the 2PC hop (reference: executor
        # extractKeyErr decodes the key; we carry the error instead)
        self.dup_info: Dict[bytes, Exception] = {}
        self.valid = True
        self.schema_check: Optional[Callable[[int], None]] = None
        self.commit_ts = 0
        # table_id -> net row delta this txn; applied to the live stats
        # count at commit (reference: mysql.stats_meta modify/count deltas
        # flushed by the session stats collector)
        self.stats_delta: Dict[int, int] = {}

    # -- reads ------------------------------------------------------------
    def get(self, key: bytes) -> bytes:
        return self.us.get(key)

    def batch_get(self, keys: List[bytes]) -> Dict[bytes, bytes]:
        """Buffer-aware batch get: buffered values shadow the snapshot;
        the rest go through the region-batched snapshot path."""
        out: Dict[bytes, bytes] = {}
        missing: List[bytes] = []
        for k in keys:
            v = self.us.buffer.get(k)
            if v is None:
                missing.append(k)
            elif v != TOMBSTONE:
                out[k] = v
        out.update(self.snapshot.batch_get(missing))
        return out

    def iter_range(self, start: Optional[bytes],
                   end: Optional[bytes]) -> Iterator[Tuple[bytes, bytes]]:
        return self.us.iter_range(start, end)

    # -- writes -----------------------------------------------------------
    def set(self, key: bytes, value: bytes) -> None:
        self.us.set(key, value)

    def insert(self, key: bytes, value: bytes,
               dup_err: Optional[Exception] = None) -> None:
        """Set with not-exists presumption — prewrite enforces uniqueness
        (reference: kv.PresumeKeyNotExists option).  Duplicates within this
        txn's own buffer are caught immediately."""
        buffered = self.us.buffer.get(key)
        if buffered not in (None, TOMBSTONE):
            raise dup_err if dup_err is not None else KeyExists(key)
        self.us.set(key, value)
        if buffered == TOMBSTONE:
            # delete-then-insert in one txn: the key existed before, so no
            # not-exists presumption — prewrite must treat it as a plain PUT
            self.presume_not_exists.discard(key)
            self.dup_info.pop(key, None)
            return
        self.presume_not_exists.add(key)
        if dup_err is not None:
            self.dup_info[key] = dup_err

    def delete(self, key: bytes) -> None:
        self.us.delete(key)

    def is_readonly(self) -> bool:
        return len(self.us.buffer) == 0

    # -- statement-level rollback (reference: session/txn.go StmtCommit /
    # StmtRollback over the membuffer) ------------------------------------
    def checkpoint(self) -> tuple:
        return (dict(self.us.buffer._m), set(self.presume_not_exists),
                dict(self.dup_info), dict(self.stats_delta))

    def restore(self, cp: tuple) -> None:
        m, pne, dup, sd = cp
        self.stats_delta = dict(sd)
        self.us.buffer._m = dict(m)
        self.us.buffer._dirty = True
        self.presume_not_exists = set(pne)
        self.dup_info = dict(dup)

    def size(self) -> int:
        return len(self.us.buffer)

    # -- lifecycle ---------------------------------------------------------
    def commit(self) -> None:
        if not self.valid:
            raise KVError("commit on invalid txn")
        self.valid = False
        committer = TwoPhaseCommitter(self)
        committer.execute()
        self.commit_ts = committer.commit_ts

    def rollback(self) -> None:
        self.valid = False


def resolve_data_dir(data_dir: Optional[str]) -> str:
    """Durability arming chain: explicit arg > TINYSQL_DATA_DIR env >
    config.data_dir; empty everywhere = today's volatile store."""
    if data_dir is not None:
        return data_dir
    import os
    env = os.environ.get("TINYSQL_DATA_DIR", "")
    if env:
        return env
    from .. import config as cfgmod
    return getattr(cfgmod.get_global_config(), "data_dir", "") or ""


class TiKVStorage:
    """Storage facade: cluster + mvcc + oracle + client + caches
    (reference: store/tikv/kv.go tikvStore + store/mockstore driver).

    With a ``data_dir`` the MVCC store journals to a WAL and recovers on
    construction (kv/wal.py); the oracle is then fenced past every
    recovered timestamp so restart loops cannot mint colliding or
    backwards timestamps."""

    def __init__(self, num_stores: int = 1,
                 data_dir: Optional[str] = None):
        from .cluster import Cluster
        from .mvcc import MVCCStore
        self.data_dir = resolve_data_dir(data_dir)
        self.cluster = Cluster()
        self.cluster.bootstrap(num_stores)
        self.mvcc = MVCCStore(self.data_dir or None)
        self.client = RPCClient(self.cluster, self.mvcc)
        self.cache = RegionCache(self.cluster)
        self.oracle = Oracle()
        if self.mvcc.recovery_info is not None:
            self.oracle.ensure_after(self.mvcc.max_known_ts())
        self.resolver = LockResolver(self.client, self.cache, self.oracle,
                                     storage=self)
        from ..distsql.copr import make_cop_handler
        self.client.cop_handler = make_cop_handler(self.mvcc)
        self._gc_last = 0.0

    def begin(self, start_ts: Optional[int] = None) -> Transaction:
        if start_ts is None:
            start_ts = self.oracle.get_timestamp()
        return Transaction(self, start_ts)

    def get_snapshot(self, ts: Optional[int] = None) -> Snapshot:
        if ts is None:
            ts = self.oracle.get_timestamp()
        return Snapshot(self, ts)

    def current_version(self) -> int:
        return self.oracle.get_timestamp()

    # ---- durability lifecycle -------------------------------------------
    def flush_and_checkpoint(self) -> None:
        """Fsync the WAL tail and fold it into a fresh checkpoint — the
        graceful-close hook (both wire modes route through here).  No-op
        on a volatile store; raises CheckpointError on a failed attempt
        (the unrotated log stays authoritative)."""
        wal = self.mvcc.wal
        if wal is None:
            return
        wal.flush()
        wal.checkpoint(self.mvcc)

    def close(self) -> None:
        """Full shutdown: checkpoint (best effort) and close the WAL."""
        wal = self.mvcc.wal
        if wal is None:
            return
        try:
            self.flush_and_checkpoint()
        except KVError:
            pass
        wal.close()

    # ---- gc safepoint trigger (satellite of the durability story) -------
    def run_gc(self, safepoint_ts: int) -> int:
        """Journal + apply one GC pass at an explicit safepoint."""
        from .wal import _bump
        removed = self.mvcc.gc(safepoint_ts)
        _bump("gc_runs")
        _bump("gc_removed", removed)
        return removed

    def maybe_run_gc(self, retention_s: float,
                     force: bool = False) -> int:
        """The `tidb_gc_safepoint` sysvar's trigger (domain owner loop):
        GC versions older than ``retention_s`` seconds, self-paced to at
        most one pass per half-retention (floor 1s).  retention<=0 =
        disabled."""
        import time as _time
        try:
            retention_s = float(retention_s)
        except (TypeError, ValueError):
            return 0
        if retention_s <= 0:
            return 0
        now = _time.time()
        if not force and now - self._gc_last < max(1.0, retention_s / 2):
            return 0
        self._gc_last = now
        from .oracle import compose_ts
        safepoint = compose_ts(int((now - retention_s) * 1000), 0)
        return self.run_gc(safepoint)


def new_mock_storage(num_stores: int = 1,
                     data_dir: Optional[str] = None) -> TiKVStorage:
    """reference: store/mockstore/tikv.go NewMockTikvStore."""
    return TiKVStorage(num_stores, data_dir=data_dir)

"""In-process Percolator MVCC store — the storage-node keystone.

Capability parity with reference store/mockstore/mocktikv/mvcc_leveldb.go
(lock/write/data column layout, prewrite/commit/rollback/scan/resolve-lock,
1,547 LoC) — the fake backend every integration test rides (SURVEY §2.7).
One instance holds the whole keyspace; the Cluster/RPC layers shard access
by region on top of it.
"""
from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from .errors import (KeyExists, KeyIsLocked, KeyNotFound, TxnAborted,
                     WriteConflict)

# Durability (kv/wal.py): when constructed with a data_dir the store
# journals every mutation inside its critical section — the journal is
# written AFTER validation but BEFORE the in-memory apply, so a failed
# append (WalError) leaves the store unmutated and a journaled record is
# always appliable on replay.

# write-record types (reference: mvcc.go WriteType)
W_PUT, W_DELETE, W_ROLLBACK = 0, 1, 2

OP_PUT, OP_DEL, OP_INSERT = 0, 1, 2  # mutation ops (kvrpcpb.Op subset)


@dataclass
class Lock:
    primary: bytes
    start_ts: int
    ttl_ms: int
    op: int
    value: bytes


@dataclass
class _Entry:
    lock: Optional[Lock] = None
    # (commit_ts desc, write_type, start_ts) — newest first
    writes: List[Tuple[int, int, int]] = field(default_factory=list)
    data: Dict[int, bytes] = field(default_factory=dict)  # start_ts -> value


@dataclass
class Mutation:
    op: int
    key: bytes
    value: bytes = b""


class MVCCStore:
    def __init__(self, data_dir: Optional[str] = None):
        self._entries: Dict[bytes, _Entry] = {}
        self._sorted: List[bytes] = []
        self._dirty = False
        self._mu = threading.RLock()
        self._wal = None
        self._replaying = False
        self.recovery_info: Optional[dict] = None
        if data_dir:
            from .wal import WriteAheadLog
            self._wal = WriteAheadLog(data_dir)
            self.recovery_info = self._wal.recover_into(self)

    @property
    def wal(self):
        return self._wal

    def _journal(self, fn) -> None:
        """Append one redo record via ``fn(wal)``; called with self._mu
        held, after validation, before the apply.  A WalError here must
        propagate — the caller skips the apply, so store and log never
        diverge with the store ahead."""
        if self._wal is not None and not self._replaying:
            fn(self._wal)

    def _maybe_checkpoint(self) -> None:
        if self._wal is not None and not self._replaying:
            self._wal.maybe_checkpoint(self)

    # ---- helpers ------------------------------------------------------
    def _entry(self, key: bytes) -> _Entry:
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = _Entry()
            self._dirty = True
        return e

    def _keys(self) -> List[bytes]:
        if self._dirty:
            self._sorted = sorted(self._entries)
            self._dirty = False
        return self._sorted

    @staticmethod
    def _find_write(e: _Entry, ts: int) -> Optional[Tuple[int, int, int]]:
        """Newest committed write with commit_ts <= ts, skipping rollbacks."""
        for w in e.writes:
            if w[0] <= ts and w[1] != W_ROLLBACK:
                return w
        return None

    # ---- reads --------------------------------------------------------
    def get(self, key: bytes, ts: int, resolved: Tuple[int, ...] = ()) -> bytes:
        with self._mu:
            e = self._entries.get(key)
            if e is None:
                raise KeyNotFound(key)
            lk = e.lock
            if lk is not None and lk.start_ts <= ts and lk.start_ts not in resolved:
                raise KeyIsLocked(key, lk.primary, lk.start_ts, lk.ttl_ms)
            w = self._find_write(e, ts)
            if w is None or w[1] == W_DELETE:
                raise KeyNotFound(key)
            return e.data[w[2]]

    def scan(self, start: Optional[bytes], end: Optional[bytes], ts: int,
             limit: int = 0, resolved: Tuple[int, ...] = ()) -> List[Tuple[bytes, bytes]]:
        out: List[Tuple[bytes, bytes]] = []
        with self._mu:
            ks = self._keys()
            i = bisect.bisect_left(ks, start) if start is not None else 0
            while i < len(ks):
                k = ks[i]
                if end is not None and k >= end:
                    break
                e = self._entries[k]
                lk = e.lock
                if lk is not None and lk.start_ts <= ts and lk.start_ts not in resolved:
                    raise KeyIsLocked(k, lk.primary, lk.start_ts, lk.ttl_ms)
                w = self._find_write(e, ts)
                if w is not None and w[1] == W_PUT:
                    out.append((k, e.data[w[2]]))
                    if limit and len(out) >= limit:
                        break
                i += 1
        return out

    # ---- bulk-load backfill -------------------------------------------
    def backfill(self, kvs: List[Tuple[bytes, bytes]], ts: int) -> int:
        """Install committed PUT records directly at a HISTORICAL
        commit_ts, bypassing Percolator — the columnar bulk-load
        materialization path (columnar/store.py ensure_row_store): the
        rows logically existed since the bulk load's timestamp, so
        every snapshot >= ts must see them, exactly as the replica
        already serves them.  Keys with any existing write or a live
        lock are skipped untouched (they are already row-store-real);
        returns the number installed."""
        with self._mu:
            installed: List[Tuple[bytes, bytes]] = []
            planned = set()
            for key, value in kvs:
                e = self._entry(key)
                if e.lock is not None or e.writes or key in planned:
                    continue
                installed.append((key, value))
                planned.add(key)
            if installed:
                self._journal(lambda w: w.log_backfill(ts, installed))
            for key, value in installed:
                e = self._entry(key)
                e.data[ts] = value
                e.writes.append((ts, W_PUT, ts))
            self._maybe_checkpoint()
        return len(installed)

    # ---- percolator write protocol ------------------------------------
    def prewrite(self, mutations: List[Mutation], primary: bytes,
                 start_ts: int, ttl_ms: int) -> None:
        """All-or-nothing prewrite of a batch (reference:
        mvcc_leveldb.go Prewrite)."""
        with self._mu:
            errs = []
            plans: List[Mutation] = []
            seen = set()
            for m in mutations:
                if m.key in seen:
                    continue  # same-batch re-prewrite is idempotent
                try:
                    if self._check_prewrite(m, primary, start_ts, ttl_ms):
                        plans.append(m)
                        seen.add(m.key)
                except (KeyIsLocked, WriteConflict, KeyExists) as ex:
                    errs.append(ex)
            if plans:
                self._journal(lambda w: w.log_prewrite(
                    primary, start_ts, ttl_ms,
                    [(m.op, m.key, m.value) for m in plans]))
            for m in plans:
                self._entry(m.key).lock = Lock(primary, start_ts, ttl_ms,
                                               m.op, m.value)
            self._maybe_checkpoint()
            if errs:
                raise errs[0]

    def _check_prewrite(self, m: Mutation, primary: bytes, start_ts: int,
                        ttl_ms: int) -> bool:
        """Validation half of prewrite: raises on conflict, returns False
        for an idempotent re-prewrite, True when a lock must be taken."""
        e = self._entry(m.key)
        if e.lock is not None:
            if e.lock.start_ts != start_ts:
                raise KeyIsLocked(m.key, e.lock.primary, e.lock.start_ts, e.lock.ttl_ms)
            return False  # idempotent re-prewrite
        if e.writes:
            newest = e.writes[0]
            if newest[0] >= start_ts:
                raise WriteConflict(m.key, start_ts, newest[0])
            # our own rollback record aborts the txn
            for w in e.writes:
                if w[2] == start_ts and w[1] == W_ROLLBACK:
                    raise WriteConflict(m.key, start_ts, w[0])
        if m.op == OP_INSERT:
            w = self._find_write(e, start_ts)
            if w is not None and w[1] == W_PUT:
                raise KeyExists(m.key)
        return True

    def commit(self, keys: List[bytes], start_ts: int, commit_ts: int) -> None:
        with self._mu:
            plans: List[Tuple[bytes, Lock]] = []
            for k in keys:
                lk = self._check_commit(k, start_ts)
                if lk is not None:
                    plans.append((k, lk))
            if plans:
                self._journal(lambda w: w.log_commit(
                    start_ts, commit_ts,
                    [(k, W_DELETE if lk.op == OP_DEL else W_PUT, lk.value)
                     for k, lk in plans]))
            for k, lk in plans:
                self._apply_commit(k, lk, start_ts, commit_ts)
            self._maybe_checkpoint()

    def _check_commit(self, key: bytes, start_ts: int) -> Optional[Lock]:
        """Validation half of commit: returns the lock to commit, None
        for an idempotent re-commit, raises TxnAborted otherwise."""
        e = self._entries.get(key)
        if e is None:
            raise TxnAborted(f"commit of unknown key {key!r}")
        lk = e.lock
        if lk is not None and lk.start_ts == start_ts:
            return lk
        # lock gone: committed already (idempotent) or rolled back (abort)
        for w in e.writes:
            if w[2] == start_ts:
                if w[1] == W_ROLLBACK:
                    raise TxnAborted(f"txn {start_ts} already rolled back")
                return None
        raise TxnAborted(f"txn {start_ts} has no lock and no write on {key!r}")

    def _apply_commit(self, key: bytes, lk: Lock, start_ts: int,
                      commit_ts: int) -> None:
        e = self._entry(key)
        wtype = W_DELETE if lk.op == OP_DEL else W_PUT
        if wtype == W_PUT:
            e.data[start_ts] = lk.value
        e.writes.append((commit_ts, wtype, start_ts))
        e.writes.sort(key=lambda w: -w[0])  # keep newest-first invariant
        if e.lock is not None and e.lock.start_ts == start_ts:
            e.lock = None

    def rollback(self, keys: List[bytes], start_ts: int) -> None:
        with self._mu:
            plans: List[bytes] = []
            for k in keys:
                e = self._entry(k)
                committed = None
                for w in e.writes:
                    if w[2] == start_ts:
                        committed = w
                        break
                if committed is not None and committed[1] != W_ROLLBACK:
                    raise TxnAborted(
                        f"cannot roll back committed txn {start_ts}")
                if ((e.lock is not None and e.lock.start_ts == start_ts)
                        or committed is None):
                    plans.append(k)
            if plans:
                self._journal(lambda w: w.log_rollback(start_ts, plans))
            for k in plans:
                e = self._entry(k)
                if e.lock is not None and e.lock.start_ts == start_ts:
                    e.lock = None
                if not any(w[2] == start_ts for w in e.writes):
                    e.writes.append((start_ts, W_ROLLBACK, start_ts))
                    e.writes.sort(key=lambda w: -w[0])
            self._maybe_checkpoint()

    # ---- recovery (lock resolution) -----------------------------------
    def check_txn_status(self, primary: bytes, lock_ts: int,
                         expired: bool) -> Tuple[int, bool]:
        """Return (commit_ts, is_committed); commit_ts==0 + False means the
        txn was (or now is) rolled back (reference: lock_resolver.go
        getTxnStatus).  `expired` tells whether the caller observed TTL
        expiry — only then may we unilaterally roll back the primary."""
        with self._mu:
            e = self._entries.get(primary)
            if e is not None:
                for w in e.writes:
                    if w[2] == lock_ts:
                        if w[1] == W_ROLLBACK:
                            return 0, False
                        return w[0], True
                lk = e.lock
                if lk is not None and lk.start_ts == lock_ts:
                    if not expired:
                        raise KeyIsLocked(primary, lk.primary, lk.start_ts, lk.ttl_ms)
                    self.rollback([primary], lock_ts)
                    return 0, False
            # no lock, no write: orphan prewrite never reached the primary —
            # write a rollback record to fence it out
            self.rollback([primary], lock_ts)
            return 0, False

    def gc(self, safepoint_ts: int) -> int:
        """Garbage-collect versions no snapshot at/after `safepoint_ts` can
        see (reference: the GC the tinykv side performs under the
        safepoint watched by store/tikv/safepoint.go).  Keeps, per key,
        the newest write with commit_ts <= safepoint plus everything
        newer; drops rollback records at/below the safepoint and orphaned
        data versions.  Returns versions removed."""
        removed = 0
        with self._mu:
            self._journal(lambda w: w.log_gc(safepoint_ts))
            for key, e in list(self._entries.items()):
                keep: List[Tuple[int, int, int]] = []
                kept_visible = False
                for w in e.writes:  # newest first
                    cts, wtype, sts = w
                    if cts > safepoint_ts:
                        keep.append(w)
                        continue
                    if wtype == W_ROLLBACK:
                        removed += 1
                        continue
                    if not kept_visible:
                        kept_visible = True
                        if wtype == W_DELETE:
                            removed += 1  # tombstone below safepoint: drop
                        else:
                            keep.append(w)
                    else:
                        removed += 1
                e.writes = keep
                live = {w[2] for w in keep}
                for sts in [s for s in e.data if s not in live]:
                    del e.data[sts]
                if not e.writes and e.lock is None and not e.data:
                    del self._entries[key]
                    self._dirty = True
            self._maybe_checkpoint()
        return removed

    def resolve_lock(self, key: bytes, start_ts: int, commit_ts: int) -> None:
        """Resolve one secondary per txn status (reference:
        lock_resolver.go resolveLock)."""
        with self._mu:
            e = self._entries.get(key)
            if e is None or e.lock is None or e.lock.start_ts != start_ts:
                return
            if commit_ts > 0:
                lk = e.lock
                wtype = W_DELETE if lk.op == OP_DEL else W_PUT
                self._journal(lambda w: w.log_resolve(
                    key, start_ts, commit_ts, wtype, lk.value))
                self._apply_commit(key, lk, start_ts, commit_ts)
                self._maybe_checkpoint()
            else:
                self.rollback([key], start_ts)

    # ---- raw/debug ----------------------------------------------------
    def locked_keys(self, start_ts: Optional[int] = None) -> List[bytes]:
        with self._mu:
            return [k for k, e in self._entries.items()
                    if e.lock is not None and
                    (start_ts is None or e.lock.start_ts == start_ts)]

    def max_known_ts(self) -> int:
        """Largest timestamp recorded anywhere in the entry map — after
        recovery the oracle must be advanced past it so a fast restart
        loop can never mint a timestamp that collides with (or sorts
        below) pre-crash history."""
        with self._mu:
            m = 0
            for e in self._entries.values():
                if e.lock is not None and e.lock.start_ts > m:
                    m = e.lock.start_ts
                for w in e.writes:
                    if w[0] > m:
                        m = w[0]
                    if w[2] > m:
                        m = w[2]
                for sts in e.data:
                    if sts > m:
                        m = sts
            return m

    # ---- recovery replay (kv/wal.py) ----------------------------------
    # Raw redo application: validation already happened when the record
    # was journaled, so these rebuild state without re-checking — the
    # byte-for-byte shape a live store would have reached.
    def _replay_prewrite(self, primary: bytes, start_ts: int, ttl_ms: int,
                         muts: List[Tuple[int, bytes, bytes]]) -> None:
        with self._mu:
            for op, key, value in muts:
                self._entry(key).lock = Lock(primary, start_ts, ttl_ms,
                                             op, value)

    def _replay_commit(self, start_ts: int, commit_ts: int,
                       items: List[Tuple[bytes, int, bytes]]) -> None:
        with self._mu:
            for key, wtype, value in items:
                e = self._entry(key)
                if wtype == W_PUT:
                    e.data[start_ts] = value
                e.writes.append((commit_ts, wtype, start_ts))
                e.writes.sort(key=lambda w: -w[0])
                if e.lock is not None and e.lock.start_ts == start_ts:
                    e.lock = None

    def _replay_rollback(self, start_ts: int, keys: List[bytes]) -> None:
        with self._mu:
            for key in keys:
                e = self._entry(key)
                if e.lock is not None and e.lock.start_ts == start_ts:
                    e.lock = None
                if not any(w[2] == start_ts for w in e.writes):
                    e.writes.append((start_ts, W_ROLLBACK, start_ts))
                    e.writes.sort(key=lambda w: -w[0])

    def _replay_resolve(self, key: bytes, start_ts: int, commit_ts: int,
                        wtype: int, value: bytes) -> None:
        if commit_ts > 0:
            self._replay_commit(start_ts, commit_ts, [(key, wtype, value)])
        else:
            self._replay_rollback(start_ts, [key])

    def _replay_gc(self, safepoint_ts: int) -> None:
        with self._mu:
            was = self._replaying
            self._replaying = True
            try:
                self.gc(safepoint_ts)
            finally:
                self._replaying = was

    def _replay_backfill(self, ts: int,
                         kvs: List[Tuple[bytes, bytes]]) -> None:
        with self._mu:
            for key, value in kvs:
                e = self._entry(key)
                e.data[ts] = value
                e.writes.append((ts, W_PUT, ts))

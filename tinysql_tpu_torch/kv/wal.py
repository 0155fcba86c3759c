"""Write-ahead log + checkpoint persistence for the MVCC store.

The reference store is durable (mvcc_leveldb.go persists every Percolator
lock/write/data column to goleveldb); this module gives `kv/mvcc.py` the
same contract without a storage engine: every MVCC mutation (prewrite /
commit / rollback / resolve / gc / backfill) is journaled as one
length-prefixed, CRC-checksummed record inside the store's existing
critical section, and a periodic checkpoint folds the log into a single
atomically-renamed snapshot of the full entry map — including in-flight
locks, so the lock-resolution ladder (`check_txn_status`) fences or
completes interrupted transactions after a restart exactly as it does on
a live store.

Layout under ``data_dir``:

- ``wal.log``       append-only record log; rotated (truncated) after
                    each checkpoint
- ``checkpoint.bin`` full entry-map snapshot + the LSN it covers;
                    written to ``checkpoint.tmp`` then atomically renamed
- ``checkpoint.tmp`` in-flight checkpoint; ignored by recovery

Record framing: ``u32 payload_len | u32 crc32(payload) | payload`` where
``payload = u64 lsn | u8 type | body``.  Recovery replays records with
``lsn > checkpoint.last_lsn`` in order and truncates the log at the first
bad length/short read/checksum — the torn-tail rule.  A torn record can
only be the final one: under the ``strict`` fsync policy every ack-bearing
record is fsynced before the client sees OK (a torn write means the fsync
never returned, so nothing was acked against it), and under
``relaxed``/``off`` the ack was never durability-promised in the first
place.  Recovery therefore never truncates behind an fsync'd ack.

Fsync policy (sysvar ``tidb_wal_fsync``, default env ``TINYSQL_WAL_FSYNC``
or ``relaxed``):

- ``strict``   fsync before acking every commit-class record
               (commit / resolve / rollback)
- ``relaxed``  group commit: commit-class records fsync at most once per
               ``GROUP_COMMIT_S`` window; a crash of the *machine* can
               lose acks inside the open window (a SIGKILL cannot — the
               bytes are already in the page cache)
- ``off``      never fsync the log (checkpoints still fsync)

Failpoints (fail/points.py): ``walAppendError`` (append raises before any
state mutates), ``walFsyncError`` (the fsync syscall fails), ``walTornTail``
(the next record is deliberately half-written — the crash-boundary lever),
``checkpointError`` (a checkpoint attempt fails/stalls; counted, never
fatal).
"""
from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from ..utils import failpoint
from .errors import CheckpointError, WalError

# ---- record types ----------------------------------------------------------
REC_PREWRITE = 1
REC_COMMIT = 2
REC_ROLLBACK = 3
REC_RESOLVE = 4
REC_GC = 5
REC_BACKFILL = 6

#: ack-bearing record types: their fsync (per policy) is the durability
#: promise behind the wire-level OK
_COMMIT_CLASS = (REC_COMMIT, REC_ROLLBACK, REC_RESOLVE)

GROUP_COMMIT_S = 0.02          # relaxed-policy group-commit window
DEFAULT_CHECKPOINT_BYTES = 4 << 20   # auto-checkpoint threshold

_CKPT_MAGIC = b"TSQLCKP1"
_FSYNC_POLICIES = ("off", "relaxed", "strict")

_HDR = struct.Struct("<II")          # payload_len, crc32
_REC = struct.Struct("<QB")          # lsn, type

# ---- process-cumulative stats (METRICS -> tsring -> /metrics) --------------
_STATS_MU = threading.Lock()
STATS: Dict[str, float] = {
    "appends": 0, "append_bytes": 0, "append_errors": 0,
    "fsyncs": 0, "fsync_s": 0.0, "fsync_errors": 0,
    "torn_writes": 0,
    "checkpoints": 0, "checkpoint_s": 0.0, "checkpoint_errors": 0,
    "recoveries": 0, "replayed_records": 0, "recovered_locks": 0,
    "truncated_tails": 0,
    "gc_runs": 0, "gc_removed": 0,
    "wal_size_bytes": 0,         # gauge: bytes in the live log
}


def _bump(key: str, n: float = 1) -> None:
    with _STATS_MU:
        STATS[key] = STATS.get(key, 0) + n


def _set(key: str, v: float) -> None:
    with _STATS_MU:
        STATS[key] = v


def stats_snapshot() -> Dict[str, float]:
    with _STATS_MU:
        return dict(STATS)


def reset_stats() -> None:
    """Test hook: zero the cumulative counters."""
    with _STATS_MU:
        for k in STATS:
            STATS[k] = 0


# ---- codec helpers ---------------------------------------------------------

def _pb(buf: bytearray, b: bytes) -> None:
    buf += struct.pack("<I", len(b))
    buf += b


def _rb(mv: memoryview, off: int) -> Tuple[bytes, int]:
    (n,) = struct.unpack_from("<I", mv, off)
    off += 4
    return bytes(mv[off:off + n]), off + n


def encode_prewrite(primary: bytes, start_ts: int, ttl_ms: int,
                    muts: List[Tuple[int, bytes, bytes]]) -> bytes:
    buf = bytearray(struct.pack("<QQ", start_ts, ttl_ms))
    _pb(buf, primary)
    buf += struct.pack("<I", len(muts))
    for op, key, value in muts:
        buf += struct.pack("<B", op)
        _pb(buf, key)
        _pb(buf, value)
    return bytes(buf)


def decode_prewrite(body: bytes):
    mv = memoryview(body)
    start_ts, ttl_ms = struct.unpack_from("<QQ", mv, 0)
    primary, off = _rb(mv, 16)
    (n,) = struct.unpack_from("<I", mv, off)
    off += 4
    muts = []
    for _ in range(n):
        (op,) = struct.unpack_from("<B", mv, off)
        off += 1
        key, off = _rb(mv, off)
        value, off = _rb(mv, off)
        muts.append((op, key, value))
    return primary, start_ts, ttl_ms, muts


def encode_commit(start_ts: int, commit_ts: int,
                  items: List[Tuple[bytes, int, bytes]]) -> bytes:
    # items carry the committed VALUE, not just the key: a commit record
    # is a self-contained redo, so replay never depends on the matching
    # prewrite record having survived
    buf = bytearray(struct.pack("<QQI", start_ts, commit_ts, len(items)))
    for key, wtype, value in items:
        buf += struct.pack("<B", wtype)
        _pb(buf, key)
        _pb(buf, value)
    return bytes(buf)


def decode_commit(body: bytes):
    mv = memoryview(body)
    start_ts, commit_ts, n = struct.unpack_from("<QQI", mv, 0)
    off = 20
    items = []
    for _ in range(n):
        (wtype,) = struct.unpack_from("<B", mv, off)
        off += 1
        key, off = _rb(mv, off)
        value, off = _rb(mv, off)
        items.append((key, wtype, value))
    return start_ts, commit_ts, items


def encode_rollback(start_ts: int, keys: List[bytes]) -> bytes:
    buf = bytearray(struct.pack("<QI", start_ts, len(keys)))
    for k in keys:
        _pb(buf, k)
    return bytes(buf)


def decode_rollback(body: bytes):
    mv = memoryview(body)
    start_ts, n = struct.unpack_from("<QI", mv, 0)
    off = 12
    keys = []
    for _ in range(n):
        k, off = _rb(mv, off)
        keys.append(k)
    return start_ts, keys


def encode_resolve(key: bytes, start_ts: int, commit_ts: int,
                   wtype: int, value: bytes) -> bytes:
    buf = bytearray(struct.pack("<QQB", start_ts, commit_ts, wtype))
    _pb(buf, key)
    _pb(buf, value)
    return bytes(buf)


def decode_resolve(body: bytes):
    mv = memoryview(body)
    start_ts, commit_ts, wtype = struct.unpack_from("<QQB", mv, 0)
    key, off = _rb(mv, 17)
    value, off = _rb(mv, off)
    return key, start_ts, commit_ts, wtype, value


def encode_gc(safepoint_ts: int) -> bytes:
    return struct.pack("<Q", safepoint_ts)


def decode_gc(body: bytes) -> int:
    return struct.unpack_from("<Q", body, 0)[0]


def encode_backfill(ts: int, kvs: List[Tuple[bytes, bytes]]) -> bytes:
    buf = bytearray(struct.pack("<QI", ts, len(kvs)))
    for k, v in kvs:
        _pb(buf, k)
        _pb(buf, v)
    return bytes(buf)


def decode_backfill(body: bytes):
    mv = memoryview(body)
    ts, n = struct.unpack_from("<QI", mv, 0)
    off = 12
    kvs = []
    for _ in range(n):
        k, off = _rb(mv, off)
        v, off = _rb(mv, off)
        kvs.append((k, v))
    return ts, kvs


# ---- checkpoint entry-map codec -------------------------------------------

def _encode_entries(entries) -> bytes:
    buf = bytearray(struct.pack("<I", len(entries)))
    for key, e in entries.items():
        _pb(buf, key)
        if e.lock is not None:
            buf += b"\x01"
            buf += struct.pack("<QQB", e.lock.start_ts, e.lock.ttl_ms,
                               e.lock.op)
            _pb(buf, e.lock.primary)
            _pb(buf, e.lock.value)
        else:
            buf += b"\x00"
        buf += struct.pack("<I", len(e.writes))
        for cts, wt, sts in e.writes:
            buf += struct.pack("<QBQ", cts, wt, sts)
        buf += struct.pack("<I", len(e.data))
        for sts, val in e.data.items():
            buf += struct.pack("<Q", sts)
            _pb(buf, val)
    return bytes(buf)


def _decode_entries(body: bytes):
    from .mvcc import Lock, _Entry
    mv = memoryview(body)
    (n_entries,) = struct.unpack_from("<I", mv, 0)
    off = 4
    entries = {}
    for _ in range(n_entries):
        key, off = _rb(mv, off)
        e = _Entry()
        has_lock = mv[off]
        off += 1
        if has_lock:
            start_ts, ttl_ms, op = struct.unpack_from("<QQB", mv, off)
            off += 17
            primary, off = _rb(mv, off)
            value, off = _rb(mv, off)
            e.lock = Lock(primary, start_ts, ttl_ms, op, value)
        (n_writes,) = struct.unpack_from("<I", mv, off)
        off += 4
        for _ in range(n_writes):
            cts, wt, sts = struct.unpack_from("<QBQ", mv, off)
            off += 17
            e.writes.append((cts, wt, sts))
        (n_data,) = struct.unpack_from("<I", mv, off)
        off += 4
        for _ in range(n_data):
            (sts,) = struct.unpack_from("<Q", mv, off)
            off += 8
            val, off = _rb(mv, off)
            e.data[sts] = val
        entries[key] = e
    return entries


class WriteAheadLog:
    """One store's journal + checkpoint lifecycle.  All appends happen
    inside the MVCC store's own RLock; this class's lock only guards the
    file descriptor against the explicit checkpoint/close entry points."""

    def __init__(self, data_dir: str,
                 fsync_policy: Optional[str] = None,
                 checkpoint_bytes: Optional[int] = None):
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.wal_path = os.path.join(data_dir, "wal.log")
        self.ckpt_path = os.path.join(data_dir, "checkpoint.bin")
        self.ckpt_tmp = os.path.join(data_dir, "checkpoint.tmp")
        policy = (fsync_policy
                  or os.environ.get("TINYSQL_WAL_FSYNC", "")
                  or "relaxed")
        self.set_fsync_policy(policy)
        self.checkpoint_bytes = int(
            checkpoint_bytes
            or os.environ.get("TINYSQL_WAL_CHECKPOINT_BYTES", 0)
            or DEFAULT_CHECKPOINT_BYTES)
        self._mu = threading.Lock()
        self._fd: Optional[int] = None
        self._lsn = 0                  # last lsn handed out
        self._ckpt_lsn = 0             # last lsn folded into checkpoint.bin
        self._wal_bytes = 0            # bytes in wal.log
        self._records_since_ckpt = 0
        self._unsynced = False
        self._last_fsync = 0.0
        self._torn = False             # a torn tail was written: poisoned
        self._closed = False

    # ---- policy ---------------------------------------------------------
    def set_fsync_policy(self, policy: str) -> None:
        p = str(policy).strip().lower()
        if p not in _FSYNC_POLICIES:
            raise ValueError(
                f"bad fsync policy {policy!r} (want off|relaxed|strict)")
        self.fsync_policy = p

    # ---- append path ----------------------------------------------------
    def _open_for_append(self) -> None:
        if self._fd is None:
            self._fd = os.open(self.wal_path,
                               os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
            self._wal_bytes = os.fstat(self._fd).st_size
            _set("wal_size_bytes", self._wal_bytes)

    def append(self, rec_type: int, body: bytes) -> int:
        """Journal one record; returns its LSN.  Raises WalError without
        having written anything when the append cannot be made (the
        caller must NOT apply the mutation it was journaling)."""
        with self._mu:
            if self._closed:
                raise WalError("wal is closed")
            if self._torn:
                # a deliberately torn record is a crash boundary: the
                # in-memory store is ahead of a log that can no longer
                # be appended to coherently
                raise WalError("wal tail is torn; store must be recovered")
            try:
                failpoint.inject("walAppendError")
            except Exception as e:
                _bump("append_errors")
                raise WalError(f"wal append failed: {e}") from e
            self._open_for_append()
            self._lsn += 1
            payload = _REC.pack(self._lsn, rec_type) + body
            frame = _HDR.pack(len(payload),
                              zlib.crc32(payload) & 0xFFFFFFFF) + payload
            if failpoint.eval("walTornTail"):
                # model the crash's final torn write: half the frame
                # reaches the file, the rest never will
                os.write(self._fd, frame[:max(1, len(frame) // 2)])
                self._torn = True
                _bump("torn_writes")
                if self.fsync_policy == "strict":
                    # strict promises fsync-before-ack: a torn record
                    # means the fsync never returned, so no ack either
                    raise WalError("torn wal write before fsync ack")
                return self._lsn
            try:
                os.write(self._fd, frame)
            except OSError as e:
                _bump("append_errors")
                raise WalError(f"wal write failed: {e}") from e
            self._wal_bytes += len(frame)
            self._records_since_ckpt += 1
            self._unsynced = True
            _bump("appends")
            _bump("append_bytes", len(frame))
            _set("wal_size_bytes", self._wal_bytes)
            if rec_type in _COMMIT_CLASS:
                if self.fsync_policy == "strict":
                    self._fsync_locked()
                elif (self.fsync_policy == "relaxed"
                      and time.monotonic() - self._last_fsync
                      >= GROUP_COMMIT_S):
                    self._fsync_locked()
            return self._lsn

    def _fsync_locked(self) -> None:
        try:
            failpoint.inject("walFsyncError")
            t0 = time.monotonic()
            os.fsync(self._fd)
            _bump("fsyncs")
            _bump("fsync_s", time.monotonic() - t0)
        except Exception as e:
            _bump("fsync_errors")
            raise WalError(f"wal fsync failed: {e}") from e
        self._unsynced = False
        self._last_fsync = time.monotonic()

    def flush(self) -> None:
        """Fsync any unsynced tail (graceful-close / policy-boundary
        hook); a no-op when everything already hit the platter."""
        with self._mu:
            if self._fd is not None and self._unsynced and not self._torn:
                self._fsync_locked()

    # ---- typed journal entry points (called under the store's RLock) ----
    def log_prewrite(self, primary: bytes, start_ts: int, ttl_ms: int,
                     muts: List[Tuple[int, bytes, bytes]]) -> int:
        return self.append(REC_PREWRITE,
                           encode_prewrite(primary, start_ts, ttl_ms, muts))

    def log_commit(self, start_ts: int, commit_ts: int,
                   items: List[Tuple[bytes, int, bytes]]) -> int:
        return self.append(REC_COMMIT,
                           encode_commit(start_ts, commit_ts, items))

    def log_rollback(self, start_ts: int, keys: List[bytes]) -> int:
        return self.append(REC_ROLLBACK, encode_rollback(start_ts, keys))

    def log_resolve(self, key: bytes, start_ts: int, commit_ts: int,
                    wtype: int, value: bytes) -> int:
        return self.append(REC_RESOLVE,
                           encode_resolve(key, start_ts, commit_ts,
                                          wtype, value))

    def log_gc(self, safepoint_ts: int) -> int:
        return self.append(REC_GC, encode_gc(safepoint_ts))

    def log_backfill(self, ts: int, kvs: List[Tuple[bytes, bytes]]) -> int:
        return self.append(REC_BACKFILL, encode_backfill(ts, kvs))

    # ---- checkpoint ------------------------------------------------------
    def maybe_checkpoint(self, store) -> None:
        """Auto-trigger: fold the log once it outgrows the threshold.
        Called at the END of a mutator (never between a record and its
        apply — a checkpoint there would mark an unapplied LSN covered).
        Failures are counted, never raised: the old checkpoint + log
        remain the recovery source."""
        if self._wal_bytes < self.checkpoint_bytes or self._torn:
            return
        try:
            self.checkpoint(store)
        except CheckpointError:
            pass

    def checkpoint(self, store) -> None:
        """Serialize the full entry map (locks included), atomically
        replace checkpoint.bin, then rotate (truncate) the log.  The
        caller must be able to hold the store's RLock; a crash between
        rename and truncate is benign because replay skips records with
        lsn <= the checkpoint's last_lsn."""
        t0 = time.monotonic()
        try:
            failpoint.inject("checkpointError")
            with store._mu:
                with self._mu:
                    last_lsn = self._lsn
                    body = _encode_entries(store._entries)
                    payload = (struct.pack("<Q", last_lsn) + body)
                    blob = (_CKPT_MAGIC + payload
                            + struct.pack("<I",
                                          zlib.crc32(payload) & 0xFFFFFFFF))
                    fd = os.open(self.ckpt_tmp,
                                 os.O_CREAT | os.O_WRONLY | os.O_TRUNC,
                                 0o644)
                    try:
                        os.write(fd, blob)
                        os.fsync(fd)
                    finally:
                        os.close(fd)
                    os.replace(self.ckpt_tmp, self.ckpt_path)
                    self._fsync_dir()
                    # rotate: everything <= last_lsn now lives in the
                    # checkpoint
                    if self._fd is not None:
                        os.ftruncate(self._fd, 0)
                        os.fsync(self._fd)
                    else:
                        open(self.wal_path, "wb").close()
                    self._ckpt_lsn = last_lsn
                    self._wal_bytes = 0
                    self._records_since_ckpt = 0
                    self._unsynced = False
                    _set("wal_size_bytes", 0)
        except Exception as e:
            _bump("checkpoint_errors")
            raise CheckpointError(f"checkpoint failed: {e}") from e
        _bump("checkpoints")
        _bump("checkpoint_s", time.monotonic() - t0)

    def _fsync_dir(self) -> None:
        try:
            dfd = os.open(self.data_dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # directory fsync is best-effort on exotic filesystems

    def is_checkpoint_clean(self) -> bool:
        """True when every journaled record is folded into checkpoint.bin
        (the graceful-close postcondition)."""
        with self._mu:
            return (self._records_since_ckpt == 0
                    and os.path.exists(self.ckpt_path))

    # ---- recovery --------------------------------------------------------
    def recover_into(self, store) -> Dict[str, float]:
        """Rebuild ``store._entries`` from checkpoint + log; re-arm lock
        TTLs from restart time; fold the replayed state into a fresh
        checkpoint.  Returns a recovery-info dict."""
        from .oracle import extract_physical
        t0 = time.monotonic()
        ckpt_loaded, last_lsn = self._load_checkpoint(store)
        self._lsn = self._ckpt_lsn = last_lsn
        replayed, truncated = self._replay(store, last_lsn)
        # TTL re-arm: a recovered lock's expiry clock restarts NOW.  Its
        # start_ts (txn identity) cannot change, and is_expired() computes
        # from the start_ts's physical part — so extend the TTL by the
        # lock's pre-crash age instead.  Without this every recovered lock
        # is instantly expired and check_txn_status would unilaterally
        # roll back txns whose coordinator may still be alive.
        now_ms = int(time.time() * 1000)
        locks = 0
        for e in store._entries.values():
            if e.lock is not None:
                age_ms = max(0, now_ms - extract_physical(e.lock.start_ts))
                e.lock.ttl_ms += age_ms
                locks += 1
        store._dirty = True
        self._open_for_append()
        # fold what we just replayed so a restart loop cannot replay
        # unboundedly; a failure (checkpointError) is counted and the
        # unrotated log stays authoritative — recovery itself remains
        # crash-consistent at every instruction
        try:
            self.checkpoint(store)
        except CheckpointError:
            pass
        _bump("recoveries")
        _bump("replayed_records", replayed)
        _bump("recovered_locks", locks)
        if truncated:
            _bump("truncated_tails")
        return {"checkpoint_loaded": ckpt_loaded,
                "checkpoint_lsn": last_lsn,
                "replayed_records": replayed,
                "truncated_tail_bytes": truncated,
                "recovered_locks": locks,
                "entries": len(store._entries),
                "wall_s": time.monotonic() - t0}

    def _load_checkpoint(self, store) -> Tuple[bool, int]:
        try:
            os.unlink(self.ckpt_tmp)  # a half-written checkpoint is noise
        except OSError:
            pass
        if not os.path.exists(self.ckpt_path):
            return False, 0
        with open(self.ckpt_path, "rb") as f:
            blob = f.read()
        if (len(blob) < len(_CKPT_MAGIC) + 12
                or blob[:len(_CKPT_MAGIC)] != _CKPT_MAGIC):
            raise WalError(f"corrupt checkpoint header in {self.ckpt_path}")
        payload, (crc,) = blob[len(_CKPT_MAGIC):-4], struct.unpack(
            "<I", blob[-4:])
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise WalError(f"checkpoint checksum mismatch in "
                           f"{self.ckpt_path}")
        (last_lsn,) = struct.unpack_from("<Q", payload, 0)
        store._entries = _decode_entries(payload[8:])
        return True, last_lsn

    def _replay(self, store, skip_upto_lsn: int) -> Tuple[int, int]:
        """Apply log records in order; truncate at the first torn/corrupt
        frame.  Returns (records applied, bytes truncated)."""
        if not os.path.exists(self.wal_path):
            return 0, 0
        replayed = 0
        with open(self.wal_path, "rb") as f:
            data = f.read()
        size = len(data)
        off = 0
        good_end = 0
        while off + _HDR.size <= size:
            plen, crc = _HDR.unpack_from(data, off)
            start = off + _HDR.size
            end = start + plen
            if plen < _REC.size or end > size:
                break  # torn length header or short final record
            payload = data[start:end]
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                break  # torn/corrupt record: the tail stops here
            lsn, rtype = _REC.unpack_from(payload, 0)
            body = payload[_REC.size:]
            if lsn > skip_upto_lsn:
                self._apply(store, rtype, body)
                replayed += 1
            self._lsn = max(self._lsn, lsn)
            off = good_end = end
        truncated = size - good_end
        if truncated:
            with open(self.wal_path, "r+b") as f:
                f.truncate(good_end)
        self._wal_bytes = good_end
        _set("wal_size_bytes", good_end)
        return replayed, truncated

    @staticmethod
    def _apply(store, rtype: int, body: bytes) -> None:
        if rtype == REC_PREWRITE:
            store._replay_prewrite(*decode_prewrite(body))
        elif rtype == REC_COMMIT:
            store._replay_commit(*decode_commit(body))
        elif rtype == REC_ROLLBACK:
            store._replay_rollback(*decode_rollback(body))
        elif rtype == REC_RESOLVE:
            store._replay_resolve(*decode_resolve(body))
        elif rtype == REC_GC:
            store._replay_gc(decode_gc(body))
        elif rtype == REC_BACKFILL:
            store._replay_backfill(*decode_backfill(body))
        else:
            raise WalError(f"unknown wal record type {rtype}")

    # ---- lifecycle -------------------------------------------------------
    def records_since_checkpoint(self) -> int:
        with self._mu:
            return self._records_since_ckpt

    def close(self) -> None:
        with self._mu:
            if self._closed:
                return
            self._closed = True
            if self._fd is not None:
                if self._unsynced and not self._torn:
                    try:
                        self._fsync_locked()
                    except WalError:
                        pass
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None

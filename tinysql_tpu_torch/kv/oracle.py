"""Timestamp oracle (TSO).

Capability parity with reference store/tikv/oracle: PD-backed TSO with async
futures (oracle/oracles/pd.go) and a local oracle for tests (local.go,
mockoracle).  Timestamps are hybrid: physical_ms << 18 | logical, so they
are globally ordered and roughly wall-clock-meaningful.
"""
from __future__ import annotations

import threading
import time

PHYSICAL_SHIFT = 18


def compose_ts(physical_ms: int, logical: int) -> int:
    return (physical_ms << PHYSICAL_SHIFT) + logical


def extract_physical(ts: int) -> int:
    return ts >> PHYSICAL_SHIFT


class Oracle:
    """Monotonic TSO — the host-side central sequencing service that replaces
    PD in the single-process build (SURVEY §2.6 wire-surface note)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._last_physical = 0
        self._logical = 0

    def get_timestamp(self) -> int:
        with self._lock:
            phys = int(time.time() * 1000)
            if phys <= self._last_physical:
                phys = self._last_physical
                self._logical += 1
            else:
                self._last_physical = phys
                self._logical = 0
            if self._logical >= (1 << PHYSICAL_SHIFT):
                self._last_physical += 1
                self._logical = 0
                phys = self._last_physical
            return compose_ts(phys, self._logical)

    def ensure_after(self, ts: int) -> None:
        """Fence the oracle past ``ts``: every future timestamp is
        strictly greater.  Recovery calls this with the max timestamp in
        the replayed entry map — a restart within the same millisecond
        (or under a skewed clock) must never re-mint a pre-crash ts."""
        with self._lock:
            if ts >= compose_ts(self._last_physical, self._logical):
                self._last_physical = ts >> PHYSICAL_SHIFT
                self._logical = ts & ((1 << PHYSICAL_SHIFT) - 1)

    def get_timestamp_async(self):
        """Lazy TSO future (reference: session.go:638-663 lazy txn +
        GetTimestampAsync): capture nothing now, fetch on .wait()."""
        return _TSFuture(self)

    def is_expired(self, lock_ts: int, ttl_ms: int) -> bool:
        now_phys = int(time.time() * 1000)
        return now_phys >= extract_physical(lock_ts) + ttl_ms

    def until_expired_ms(self, lock_ts: int, ttl_ms: int) -> int:
        now_phys = int(time.time() * 1000)
        return extract_physical(lock_ts) + ttl_ms - now_phys


class _TSFuture:
    __slots__ = ("_oracle", "_ts")

    def __init__(self, oracle: Oracle):
        self._oracle = oracle
        self._ts = None

    def wait(self) -> int:
        if self._ts is None:
            self._ts = self._oracle.get_timestamp()
        return self._ts

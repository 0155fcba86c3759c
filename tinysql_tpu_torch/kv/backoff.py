"""Typed exponential backoff budgets (reference: store/tikv/backoff.go:98-222).

Each retry class has its own base/cap; a Backoffer carries a total budget and
raises BackoffExceeded when spent.  `SLEEP_SCALE` lets tests run the full
retry ladder without real wall-clock sleeps.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Dict

from ..utils import interrupt
from .errors import BackoffExceeded, TaskCancelled

SLEEP_SCALE = 1.0  # tests set tinysql_tpu.kv.backoff.SLEEP_SCALE = 0


@dataclass(frozen=True)
class BackoffType:
    name: str
    base_ms: int
    cap_ms: int

    def sleep_ms(self, attempt: int) -> float:
        v = min(self.cap_ms, self.base_ms * (2 ** attempt))
        return v / 2 + random.random() * v / 2  # equal-jitter


BO_RPC = BackoffType("tikvRPC", 100, 2000)
BO_REGION_MISS = BackoffType("regionMiss", 2, 500)
BO_TXN_LOCK = BackoffType("txnLock", 200, 3000)
BO_TXN_LOCK_FAST = BackoffType("txnLockFast", 100, 3000)
BO_PD_RPC = BackoffType("pdRPC", 500, 3000)

GET_MAX_BACKOFF = 20000
SCAN_MAX_BACKOFF = 20000
PREWRITE_MAX_BACKOFF = 20000
COMMIT_MAX_BACKOFF = 41000
COP_NEXT_MAX_BACKOFF = 20000
CLEANUP_MAX_BACKOFF = 20000


class Backoffer:
    def __init__(self, max_sleep_ms: int, cancel=None,
                 interruptible: bool = True):
        """``cancel``: optional threading.Event — a set event aborts the
        NEXT backoff with TaskCancelled instead of sleeping (the distsql
        early-close path), and an in-flight sleep wakes on it.
        ``interruptible=False`` exempts this ladder from the statement
        kill/deadline check: the 2PC COMMIT phase sets it, because once
        the primary batch committed the txn is durable and aborting a
        secondary retry would misreport a committed txn as interrupted
        (and skip its columnar invalidation)."""
        self.max_sleep_ms = max_sleep_ms
        self.total_ms = 0.0
        self.attempts: Dict[str, int] = {}
        self.errors = []
        self.cancel = cancel
        self.interruptible = interruptible

    def backoff(self, bo: BackoffType, err: Exception) -> None:
        # statement kill / max_execution_time both land here: a retry
        # ladder is exactly where a doomed statement would otherwise
        # burn its whole budget before noticing
        if self.interruptible:
            interrupt.check()
        if self.cancel is not None and self.cancel.is_set():
            raise TaskCancelled(f"cancelled during {bo.name} backoff") \
                from err
        self.errors.append(err)
        n = self.attempts.get(bo.name, 0)
        self.attempts[bo.name] = n + 1
        ms = bo.sleep_ms(n)
        self.total_ms += ms
        if self.total_ms >= self.max_sleep_ms:
            raise BackoffExceeded(
                f"backoff budget {self.max_sleep_ms}ms exceeded; "
                f"errors: {self.errors[-5:]}") from err
        if SLEEP_SCALE > 0:
            if self.cancel is not None:
                self.cancel.wait(ms / 1000.0 * SLEEP_SCALE)
            else:
                time.sleep(ms / 1000.0 * SLEEP_SCALE)

    def fork(self) -> "Backoffer":
        b = Backoffer(self.max_sleep_ms, cancel=self.cancel,
                      interruptible=self.interruptible)
        b.total_ms = self.total_ms
        return b

"""Batched auto-increment allocator.

Capability parity with reference meta/autoid/autoid.go: allocates handle/
auto-increment IDs in steps (one meta txn reserves a batch; subsequent
allocs are in-memory until the batch drains), with Rebase on explicit
user-supplied ids (autoid.go:122-214).
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

DEFAULT_STEP = 4000  # reference: autoid.go step


class Allocator:
    def __init__(self, storage, table_id: int, step: int = DEFAULT_STEP):
        self.storage = storage
        self.table_id = table_id
        self.step = step
        self._base = 0
        self._end = 0
        self._mu = threading.Lock()

    def _reserve(self, at_least: int = 0) -> None:
        from .meta import Meta
        from ..kv.errors import KVError
        # concurrent allocators race on the same meta key; retry the small
        # reservation txn on conflict (reference: autoid.go retries via
        # kv.RunInNewTxn)
        last_err = None
        for _ in range(10):
            txn = self.storage.begin()
            m = Meta(txn)
            if at_least:
                m.rebase_autoid(self.table_id, at_least)
            end = m.advance_autoid(self.table_id, self.step)
            try:
                txn.commit()
            except KVError as e:
                last_err = e
                continue
            self._base = end - self.step
            self._end = end
            return
        raise last_err

    def alloc(self) -> int:
        with self._mu:
            if self._base >= self._end:
                self._reserve()
            self._base += 1
            return self._base

    def rebase(self, v: int) -> None:
        """Ensure future allocs are > v (user wrote an explicit id)."""
        with self._mu:
            if v < self._base:
                return
            if v < self._end:
                self._base = max(self._base, v)
                return
            self._reserve(at_least=v)

    def base(self) -> int:
        with self._mu:
            return self._base

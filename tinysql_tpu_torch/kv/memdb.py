"""Sorted in-memory write buffer.

Capability parity with reference kv/memdb (skiplist-in-arena membuffer,
memdb.go:28-296) + BufferStore/UnionStore (buffer_store.go, union_store.go):
a transaction's uncommitted writes, ordered, merged over a snapshot on read.
Python build: dict + lazily-sorted key list (teaching-scale data; the hot
read path is columnar/TPU, not this buffer).
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterator, List, Optional, Tuple

from .errors import KeyNotFound

TOMBSTONE = b""  # empty value marks deletion inside a txn buffer


class MemDB:
    """Ordered key-value buffer; empty value = delete marker."""

    def __init__(self):
        self._m: Dict[bytes, bytes] = {}
        self._sorted: List[bytes] = []
        self._dirty = False

    def __len__(self) -> int:
        return len(self._m)

    def set(self, key: bytes, value: bytes) -> None:
        if key not in self._m:
            self._dirty = True
        self._m[key] = value

    def delete(self, key: bytes) -> None:
        self.set(key, TOMBSTONE)

    def get(self, key: bytes) -> Optional[bytes]:
        """Returns the buffered value; TOMBSTONE if deleted; None if absent."""
        return self._m.get(key)

    def _keys(self) -> List[bytes]:
        if self._dirty:
            self._sorted = sorted(self._m)
            self._dirty = False
        return self._sorted

    def iter_range(self, start: Optional[bytes] = None,
                   end: Optional[bytes] = None) -> Iterator[Tuple[bytes, bytes]]:
        ks = self._keys()
        i = bisect.bisect_left(ks, start) if start is not None else 0
        while i < len(ks):
            k = ks[i]
            if end is not None and k >= end:
                return
            yield k, self._m[k]
            i += 1

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        return self.iter_range()


class UnionStore:
    """Txn membuffer over a snapshot (reference: kv/union_store.go): reads
    check the buffer first; range scans merge the two ordered sources."""

    def __init__(self, snapshot):
        self.buffer = MemDB()
        self.snapshot = snapshot

    def get(self, key: bytes) -> bytes:
        v = self.buffer.get(key)
        if v is not None:
            if v == TOMBSTONE:
                raise KeyNotFound(key)
            return v
        return self.snapshot.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        if value == TOMBSTONE:
            raise ValueError("empty values are reserved as delete markers")
        self.buffer.set(key, value)

    def delete(self, key: bytes) -> None:
        self.buffer.delete(key)

    def iter_range(self, start: Optional[bytes],
                   end: Optional[bytes]) -> Iterator[Tuple[bytes, bytes]]:
        """Two-source ordered merge (reference: kv/union_iter.go)."""
        buf = self.buffer.iter_range(start, end)
        snap = self.snapshot.iter_range(start, end)
        bk = next(buf, None)
        sk = next(snap, None)
        while bk is not None or sk is not None:
            if sk is None or (bk is not None and bk[0] <= sk[0]):
                if sk is not None and bk[0] == sk[0]:
                    sk = next(snap, None)  # buffer shadows snapshot
                if bk[1] != TOMBSTONE:
                    yield bk
                bk = next(buf, None)
            else:
                yield sk
                sk = next(snap, None)

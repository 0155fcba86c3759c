"""Raw (non-transactional) KV client — reference: store/tikv/rawkv.go
(RawKVClient Get/BatchGet/Put/BatchPut/Delete/Scan over the raw column
family, region-routed with backoff retry, bypassing MVCC timestamps).

The raw keyspace lives beside the MVCC entries in the mock store (the
reference's raw CF beside the txn CFs); raw writes are immediately
visible — no locks, no commit point, no snapshot isolation.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from . import backoff as bo
from .backoff import Backoffer
from .errors import RegionError
from .rpc import RegionCache, RegionCtx, RPCClient


class RawStore:
    """The raw column family: a sorted plain keyspace on the storage
    node (no MVCC versions)."""

    def __init__(self):
        self._kv: Dict[bytes, bytes] = {}
        self._sorted: List[bytes] = []
        self._dirty = False
        self._mu = threading.RLock()

    def put(self, key: bytes, value: bytes) -> None:
        with self._mu:
            if key not in self._kv:
                self._dirty = True
            self._kv[key] = value

    def get(self, key: bytes) -> Optional[bytes]:
        with self._mu:
            return self._kv.get(key)

    def delete(self, key: bytes) -> None:
        with self._mu:
            if self._kv.pop(key, None) is not None:
                self._dirty = True

    def scan(self, start: bytes, end: bytes,
             limit: int) -> List[Tuple[bytes, bytes]]:
        with self._mu:
            if self._dirty:
                self._sorted = sorted(self._kv)
                self._dirty = False
            out = []
            import bisect
            i = bisect.bisect_left(self._sorted, start)
            while i < len(self._sorted) and len(out) < limit:
                k = self._sorted[i]
                if end and k >= end:
                    break
                out.append((k, self._kv[k]))
                i += 1
            return out


class RawKVClient:
    """Client side: region routing + typed backoff retry, same loop shape
    as the transactional client (rawkv.go:30-188)."""

    def __init__(self, client: RPCClient, cache: RegionCache):
        self.client = client
        self.cache = cache

    def _retry(self, key: bytes, fn):
        boer = Backoffer(bo.COP_NEXT_MAX_BACKOFF)
        while True:
            r = self.cache.locate_key(key)
            try:
                return fn(RegionCtx(r.id, r.epoch), r)
            except RegionError as e:
                self.cache.invalidate(r.id)
                boer.backoff(bo.BO_REGION_MISS, e)

    def get(self, key: bytes) -> Optional[bytes]:
        return self._retry(key, lambda ctx, _r:
                           self.client.raw_get(ctx, key))

    def put(self, key: bytes, value: bytes) -> None:
        self._retry(key, lambda ctx, _r:
                    self.client.raw_put(ctx, key, value))

    def delete(self, key: bytes) -> None:
        self._retry(key, lambda ctx, _r:
                    self.client.raw_delete(ctx, key))

    def batch_put(self, pairs: List[Tuple[bytes, bytes]]) -> None:
        """Group by region, one RPC per group (rawkv.go BatchPut)."""
        boer = Backoffer(bo.COP_NEXT_MAX_BACKOFF)
        pending = list(pairs)
        while pending:
            groups = self.cache.group_by_region(pending, lambda p: p[0])
            retry: List[Tuple[bytes, bytes]] = []
            for region, items in groups:
                try:
                    self.client.raw_batch_put(
                        RegionCtx(region.id, region.epoch), items)
                except RegionError as e:
                    self.cache.invalidate(region.id)
                    boer.backoff(bo.BO_REGION_MISS, e)
                    retry.extend(items)
            pending = retry

    def scan(self, start: bytes, end: bytes,
             limit: int = 1024) -> List[Tuple[bytes, bytes]]:
        """Cross-region scan: per-region RPCs stitched in key order."""
        out: List[Tuple[bytes, bytes]] = []
        cur = start
        boer = Backoffer(bo.COP_NEXT_MAX_BACKOFF)
        while len(out) < limit and (not end or cur < end or not cur):
            r = self.cache.locate_key(cur)
            sub_end = min(r.end, end) if (r.end and end) else (r.end or end)
            try:
                got = self.client.raw_scan(
                    RegionCtx(r.id, r.epoch), cur, sub_end,
                    limit - len(out))
            except RegionError as e:
                self.cache.invalidate(r.id)
                boer.backoff(bo.BO_REGION_MISS, e)
                continue
            out.extend(got)
            from .cluster import INF
            if not r.end or r.end >= INF:
                break  # last region (the cluster's end sentinel is INF)
            cur = r.end
            if end and cur >= end:
                break
        return out[:limit]

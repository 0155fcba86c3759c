"""In-process RPC layer: region-validated dispatch to the MVCC store.

Capability parity with reference store/mockstore/mocktikv/rpc.go:351-550
(simulated region errors — epoch-not-match, region-not-found, store-down —
before dispatching kv/cop requests) + store/tikv/region_cache.go +
region_request.go (client-side routing cache with invalidation and retry).
The "network" is a function call; everything else — routing, staleness,
partitioning — is real.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..utils import failpoint
from .cluster import Cluster, Region
from .errors import KeyNotFound, RegionError
from .mvcc import MVCCStore, Mutation


@dataclass(frozen=True)
class RegionCtx:
    region_id: int
    epoch: int


class RPCClient:
    """Server side of the fake wire: validates the caller's region view
    against the live topology, then executes against the MVCC store."""

    def __init__(self, cluster: Cluster, store: MVCCStore):
        self.cluster = cluster
        self.mvcc = store
        self.cop_handler = None  # installed by distsql layer
        self._raw_mu = threading.Lock()  # guards the lazy _raw attach

    # ---- validation ----------------------------------------------------
    def _check(self, ctx: RegionCtx, keys: List[bytes] = (),
               ranges: List[Tuple[bytes, bytes]] = ()) -> Region:
        if failpoint.eval("rpcServerBusy"):
            raise RegionError("server_busy", ctx.region_id)
        r = self.cluster.get_region_by_id(ctx.region_id)
        if r is None:
            raise RegionError("region_not_found", ctx.region_id)
        st = self.cluster.stores.get(r.store_id)
        if st is None or not st.up:
            raise RegionError("store_down", ctx.region_id)
        if st.cancelled:
            raise RegionError("store_cancelled", ctx.region_id)
        self.cluster.maybe_delay(r.store_id)
        if r.epoch != ctx.epoch:
            raise RegionError("epoch_not_match", ctx.region_id)
        for k in keys:
            if not r.contains(k):
                raise RegionError("key_not_in_region", ctx.region_id)
        for s, e in ranges:
            if s < r.start or (e > r.end):
                raise RegionError("range_not_in_region", ctx.region_id)
        return r

    # ---- kv commands ----------------------------------------------------
    def kv_get(self, ctx: RegionCtx, key: bytes, ts: int,
               resolved: Tuple[int, ...] = ()) -> bytes:
        self._check(ctx, keys=[key])
        return self.mvcc.get(key, ts, resolved)

    def kv_batch_get(self, ctx: RegionCtx, keys: List[bytes], ts: int,
                     resolved: Tuple[int, ...] = ()) -> List[Tuple[bytes, bytes]]:
        """Region-batched point gets (reference: kvrpcpb BatchGet)."""
        self._check(ctx, keys=keys)
        out = []
        for k in keys:
            try:
                out.append((k, self.mvcc.get(k, ts, resolved)))
            except KeyNotFound:
                pass
        return out

    def kv_scan(self, ctx: RegionCtx, start: bytes, end: bytes, ts: int,
                limit: int = 0,
                resolved: Tuple[int, ...] = ()) -> List[Tuple[bytes, bytes]]:
        r = self._check(ctx)
        s = max(start, r.start)
        e = min(end, r.end) if end else r.end
        return self.mvcc.scan(s, e, ts, limit, resolved)

    def kv_prewrite(self, ctx: RegionCtx, mutations: List[Mutation],
                    primary: bytes, start_ts: int, ttl_ms: int) -> None:
        failpoint.inject("prewriteError")
        self._check(ctx, keys=[m.key for m in mutations])
        self.mvcc.prewrite(mutations, primary, start_ts, ttl_ms)

    def kv_commit(self, ctx: RegionCtx, keys: List[bytes], start_ts: int,
                  commit_ts: int) -> None:
        failpoint.inject("commitError")
        self._check(ctx, keys=keys)
        self.mvcc.commit(keys, start_ts, commit_ts)

    def kv_rollback(self, ctx: RegionCtx, keys: List[bytes], start_ts: int) -> None:
        self._check(ctx, keys=keys)
        self.mvcc.rollback(keys, start_ts)

    def kv_check_txn_status(self, ctx: RegionCtx, primary: bytes,
                            lock_ts: int, expired: bool) -> Tuple[int, bool]:
        self._check(ctx, keys=[primary])
        return self.mvcc.check_txn_status(primary, lock_ts, expired)

    def kv_resolve_lock(self, ctx: RegionCtx, key: bytes, start_ts: int,
                        commit_ts: int) -> None:
        self._check(ctx, keys=[key])
        self.mvcc.resolve_lock(key, start_ts, commit_ts)

    def coprocessor(self, ctx: RegionCtx, req) -> bytes:
        r = self._check(ctx)
        if self.cop_handler is None:
            raise RuntimeError("no coprocessor handler installed")
        return self.cop_handler(r, req)

    # ---- raw commands (non-transactional CF; reference rawkv.go) -------
    @property
    def raw(self):
        """Lazily-attached raw column family (rawkv.RawStore).  The
        attach is locked: connection threads share one RPCClient, and
        two racing first-touches would each build a RawStore — one
        thread's raw writes silently vanishing with its loser copy."""
        rs = getattr(self, "_raw", None)
        if rs is None:
            from .rawkv import RawStore
            with self._raw_mu:
                rs = getattr(self, "_raw", None)
                if rs is None:
                    rs = self._raw = RawStore()
        return rs

    def raw_get(self, ctx: RegionCtx, key: bytes):
        self._check(ctx, keys=[key])
        return self.raw.get(key)

    def raw_put(self, ctx: RegionCtx, key: bytes, value: bytes) -> None:
        self._check(ctx, keys=[key])
        self.raw.put(key, value)

    def raw_delete(self, ctx: RegionCtx, key: bytes) -> None:
        self._check(ctx, keys=[key])
        self.raw.delete(key)

    def raw_batch_put(self, ctx: RegionCtx, pairs) -> None:
        self._check(ctx, keys=[k for k, _ in pairs])
        for k, v in pairs:
            self.raw.put(k, v)

    def raw_scan(self, ctx: RegionCtx, start: bytes, end: bytes,
                 limit: int):
        r = self._check(ctx)
        s = max(start, r.start) if r.start else start
        e = min(end, r.end) if (end and r.end) else (end or r.end)
        return self.raw.scan(s, e, limit)


class RegionCache:
    """Client-side key->region routing cache with invalidation
    (reference: region_cache.go:167-267)."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster  # stands in for PD
        self._mu = threading.Lock()
        self._by_id: Dict[int, Region] = {}

    def locate_key(self, key: bytes) -> Region:
        with self._mu:
            for r in self._by_id.values():
                if r.contains(key):
                    return r
        r = self.cluster.locate(key)  # "PD" lookup
        with self._mu:
            self._by_id[r.id] = r
        return r

    def invalidate(self, region_id: int) -> None:
        with self._mu:
            self._by_id.pop(region_id, None)

    def invalidate_all(self) -> None:
        with self._mu:
            self._by_id.clear()

    def group_by_region(self, items, key_fn) -> List[Tuple[Region, list]]:
        """Generic locate-and-group (reference: 2pc.go GroupKeysByRegion) —
        single implementation shared by prewrite/commit/batch-get paths."""
        groups: Dict[int, Tuple[Region, list]] = {}
        for item in sorted(items, key=key_fn):
            r = self.locate_key(key_fn(item))
            groups.setdefault(r.id, (r, []))[1].append(item)
        return list(groups.values())

    def group_keys_by_region(self, keys: List[bytes]) -> List[Tuple[Region, List[bytes]]]:
        return self.group_by_region(keys, lambda k: k)

    def split_range_by_regions(self, start: bytes, end: bytes) -> List[Tuple[Region, bytes, bytes]]:
        """Split [start,end) into per-region subranges (reference:
        coprocessor.go:204 buildCopTasks)."""
        out: List[Tuple[Region, bytes, bytes]] = []
        cur = start
        while cur < end:
            r = self.locate_key(cur)
            sub_end = min(end, r.end)
            out.append((r, cur, sub_end))
            cur = sub_end
        return out

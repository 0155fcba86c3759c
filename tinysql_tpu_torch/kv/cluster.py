"""In-memory cluster topology simulator: regions, stores, chaos hooks.

Capability parity with reference store/mockstore/mocktikv/cluster.go:40-353:
Bootstrap, AllocID, Split/Merge, StopStore/CancelStore (partition simulation),
request delay injection.  Regions shard the keyspace exactly as TinyKV's do;
on TPU they are the unit that maps to mesh shards (SURVEY §2.6 note).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Region:
    id: int
    start: bytes              # inclusive; b"" = -inf
    end: bytes                # exclusive; b"\xff"*64 sentinel = +inf
    epoch: int
    store_id: int

    def contains(self, key: bytes) -> bool:
        return self.start <= key and (key < self.end)


INF = b"\xff" * 64


@dataclass
class Store:
    id: int
    up: bool = True
    cancelled: bool = False   # requests dropped silently (timeout)
    delay_ms: float = 0.0


class Cluster:
    def __init__(self):
        self._mu = threading.RLock()
        self._id = 0
        self.stores: Dict[int, Store] = {}
        self.regions: List[Region] = []

    # ---- bootstrap / ids ----------------------------------------------
    def alloc_id(self) -> int:
        with self._mu:
            self._id += 1
            return self._id

    def bootstrap(self, num_stores: int = 1) -> None:
        with self._mu:
            for _ in range(num_stores):
                sid = self.alloc_id()
                self.stores[sid] = Store(sid)
            first = list(self.stores)[0]
            self.regions = [Region(self.alloc_id(), b"", INF, 1, first)]

    # ---- lookup --------------------------------------------------------
    def locate(self, key: bytes) -> Region:
        with self._mu:
            for r in self.regions:
                if r.contains(key):
                    return Region(r.id, r.start, r.end, r.epoch, r.store_id)
            raise RuntimeError(f"no region for key {key!r}")

    def get_region_by_id(self, rid: int) -> Optional[Region]:
        with self._mu:
            for r in self.regions:
                if r.id == rid:
                    return Region(r.id, r.start, r.end, r.epoch, r.store_id)
            return None

    def all_regions(self) -> List[Region]:
        with self._mu:
            return [Region(r.id, r.start, r.end, r.epoch, r.store_id)
                    for r in sorted(self.regions, key=lambda r: r.start)]

    # ---- topology changes ----------------------------------------------
    def split(self, split_key: bytes) -> None:
        """Split the region containing split_key (reference: cluster.go Split)."""
        with self._mu:
            for i, r in enumerate(self.regions):
                if r.contains(split_key) and r.start != split_key:
                    new = Region(self.alloc_id(), split_key, r.end,
                                 1, r.store_id)
                    r.end = split_key
                    r.epoch += 1
                    self.regions.insert(i + 1, new)
                    return

    def split_table(self, table_id: int) -> None:
        from ..codec import tablecodec
        self.split(tablecodec.encode_table_prefix(table_id))

    def split_keys(self, keys: List[bytes]) -> None:
        for k in keys:
            self.split(k)

    def merge(self, rid_a: int, rid_b: int) -> None:
        with self._mu:
            a = next(r for r in self.regions if r.id == rid_a)
            b = next(r for r in self.regions if r.id == rid_b)
            if a.end != b.start:
                raise RuntimeError("regions not adjacent")
            a.end = b.end
            a.epoch += 1
            self.regions.remove(b)

    def move_region(self, rid: int, store_id: int) -> None:
        with self._mu:
            r = next(x for x in self.regions if x.id == rid)
            r.store_id = store_id
            r.epoch += 1

    # ---- chaos ---------------------------------------------------------
    def stop_store(self, sid: int) -> None:
        with self._mu:
            self.stores[sid].up = False

    def start_store(self, sid: int) -> None:
        with self._mu:
            self.stores[sid].up = True
            self.stores[sid].cancelled = False

    def cancel_store(self, sid: int) -> None:
        with self._mu:
            self.stores[sid].cancelled = True

    def set_delay(self, sid: int, ms: float) -> None:
        with self._mu:
            self.stores[sid].delay_ms = ms

    def maybe_delay(self, sid: int) -> None:
        with self._mu:
            d = self.stores[sid].delay_ms if sid in self.stores else 0
        if d:
            time.sleep(d / 1000.0)  # qlint: disable=FP501 -- the injected store latency IS the simulated fault, not a retry sleep

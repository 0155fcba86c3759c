"""Count-Min sketch + FM sketch + reservoir sampling.

Capability parity with reference statistics/cmsketch.go:29-171 (d x w
counters, point-frequency estimate — the course stubs :52/:70 implemented
for real, numpy-vectorized), statistics/fmsketch.go (distinct-count
estimation), statistics/sample.go (reservoir sampling during ANALYZE).
"""
from __future__ import annotations

import hashlib
import random
import struct
from typing import List, Optional

import numpy as np

from ..mytypes import Datum


def _hash128(data: bytes) -> tuple:
    h = hashlib.blake2b(data, digest_size=16).digest()
    return struct.unpack("<QQ", h)


def _encode_datum(v: Datum) -> bytes:
    if v is None:
        return b"\x00"
    if isinstance(v, bool):
        v = int(v)
    if isinstance(v, int):
        # normalize mod 2^64 so a wrapped -1 and unwrapped 2^64-1 hash the
        # same (the two ANALYZE paths may see either representation)
        return b"i" + struct.pack("<Q", v & ((1 << 64) - 1))
    if isinstance(v, float):
        return b"f" + struct.pack("<d", v)
    return b"s" + str(v).encode("utf-8", "surrogateescape")


class CMSketch:
    """Count-Min: insert adds 1 to one counter per row; query takes the
    min over rows (reference: cmsketch.go InsertBytes :52 / queryBytes :70)."""

    def __init__(self, depth: int = 5, width: int = 2048):
        self.depth = depth
        self.width = width
        self.count = 0
        self.table = np.zeros((depth, width), dtype=np.uint32)

    def _positions(self, data: bytes) -> np.ndarray:
        h1, h2 = _hash128(data)
        # d independent hashes via h1 + i*h2 (Kirsch-Mitzenmacher)
        idx = (h1 + np.arange(self.depth, dtype=np.uint64) * np.uint64(h2 & ((1 << 63) - 1)))
        return (idx % np.uint64(self.width)).astype(np.int64)

    def insert(self, v: Datum, count: int = 1) -> None:
        self.insert_bytes(_encode_datum(v), count)

    def insert_bytes(self, data: bytes, count: int = 1) -> None:
        pos = self._positions(data)
        self.table[np.arange(self.depth), pos] += np.uint32(count)
        self.count += count

    def query(self, v: Datum) -> int:
        return self.query_bytes(_encode_datum(v))

    def query_bytes(self, data: bytes) -> int:
        pos = self._positions(data)
        vals = self.table[np.arange(self.depth), pos]
        # noise correction (reference: queryBytes subtracts the estimated
        # uniform noise, clamped)
        noise = self.count / self.width
        adjusted = np.where(vals > noise, vals - noise, 0.0)
        return int(min(vals.min(), np.mean(adjusted) + 0.5))

    def merge(self, other: "CMSketch") -> None:
        assert (self.depth, self.width) == (other.depth, other.width)
        self.table += other.table
        self.count += other.count

    def to_dict(self) -> dict:
        return {"depth": self.depth, "width": self.width,
                "count": self.count, "rows": self.table.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "CMSketch":
        s = cls(d["depth"], d["width"])
        s.count = d["count"]
        s.table = np.array(d["rows"], dtype=np.uint32)
        return s


class FMSketch:
    """Flajolet-Martin distinct-count sketch (reference: fmsketch.go):
    keep hashes whose trailing zeros >= current mask level, bounded set."""

    def __init__(self, max_size: int = 10_000):
        self.max_size = max_size
        self.mask = np.uint64(0)
        self.hashset: set = set()

    def insert(self, v: Datum) -> None:
        h, _ = _hash128(_encode_datum(v))
        h = np.uint64(h)
        if h & self.mask == 0:
            self.hashset.add(int(h))
            if len(self.hashset) > self.max_size:
                self.mask = np.uint64((int(self.mask) << 1) | 1)
                self.hashset = {x for x in self.hashset
                                if x & int(self.mask) == 0}

    def ndv(self) -> int:
        return (int(self.mask) + 1) * len(self.hashset)

    def merge(self, other: "FMSketch") -> None:
        """Union two sketches (per-region ANALYZE partials): lift both to
        the coarser mask, union the surviving hashes, shrink as needed."""
        mask = max(int(self.mask), int(other.mask))
        merged = {x for x in self.hashset if x & mask == 0}
        merged |= {x for x in other.hashset if x & mask == 0}
        while len(merged) > self.max_size:
            mask = (mask << 1) | 1
            merged = {x for x in merged if x & mask == 0}
        self.mask = np.uint64(mask)
        self.hashset = merged


class ReservoirSampler:
    """Fixed-size uniform row sample (reference: sample.go
    SampleCollector)."""

    def __init__(self, capacity: int = 10_000, seed: int = 1):
        self.capacity = capacity
        self.samples: List[Datum] = []
        self.seen = 0
        self.null_count = 0
        self._rng = random.Random(seed)
        self.fm = FMSketch()
        self.cms = CMSketch()

    def collect(self, v: Datum) -> None:
        if v is None:
            self.null_count += 1
            return
        self.fm.insert(v)
        self.cms.insert(v)
        self.seen += 1
        if len(self.samples) < self.capacity:
            self.samples.append(v)
            return
        j = self._rng.randrange(self.seen)
        if j < self.capacity:
            self.samples[j] = v

    def collect_column(self, values: np.ndarray, null: np.ndarray) -> None:
        for i in range(len(values)):
            self.collect(None if null[i] else
                         (values[i].item() if hasattr(values[i], "item")
                          else values[i]))

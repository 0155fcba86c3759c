"""Equal-depth histograms + estimation.

Capability parity with reference statistics/histogram.go:38-79 (buckets
{lower, upper, count, repeat}) and the row-count estimators :255-306
(equal/less/greater/between), built numpy-first: the histogram is
constructed from sorted sample arrays in one vectorized pass.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..mytypes import Datum, coerce_for_compare, datum_compare


@dataclass
class Bucket:
    lower: Datum
    upper: Datum
    count: int       # cumulative rows up to and including this bucket
    repeat: int      # occurrences of `upper`


@dataclass
class Histogram:
    col_id: int
    ndv: int = 0
    null_count: int = 0
    total_count: int = 0
    buckets: List[Bucket] = field(default_factory=list)

    # ---- construction ---------------------------------------------------
    @classmethod
    def build(cls, col_id: int, values: List[Datum], null_count: int = 0,
              max_buckets: int = 64) -> "Histogram":
        """Build an equal-depth histogram from (non-null) sample values
        (reference: statistics/builder.go BuildColumn)."""
        h = cls(col_id, null_count=null_count)
        vals = sorted((v for v in values if v is not None),
                      key=_sort_key)
        n = len(vals)
        h.total_count = n + null_count
        if n == 0:
            return h
        per = max(1, (n + max_buckets - 1) // max_buckets)
        ndv = 1
        i = 0
        while i < n:
            j = min(i + per, n)
            # extend bucket to include all duplicates of the boundary value
            while j < n and datum_compare(vals[j], vals[j - 1]) == 0:
                j += 1
            upper = vals[j - 1]
            repeat = 1
            k = j - 2
            while k >= i and datum_compare(vals[k], upper) == 0:
                repeat += 1
                k -= 1
            h.buckets.append(Bucket(vals[i], upper, j, repeat))
            i = j
        # ndv
        ndv = 1
        for a, b in zip(vals, vals[1:]):
            if datum_compare(a, b) != 0:
                ndv += 1
        h.ndv = ndv
        return h

    # ---- estimation (reference: histogram.go estimate fns) -------------
    def not_null_count(self) -> int:
        return self.buckets[-1].count if self.buckets else 0

    def avg_count_per_value(self) -> float:
        nn = self.not_null_count()
        return nn / max(self.ndv, 1)

    def equal_row_count(self, v: Datum) -> float:
        if v is None:
            return float(self.null_count)
        idx = self._bucket_index(v)
        if idx < 0:
            return 0.0
        b = self.buckets[idx]
        if datum_compare(v, b.upper) == 0:
            return float(b.repeat)
        return self.avg_count_per_value()

    def less_row_count(self, v: Datum) -> float:
        """Rows strictly < v (NULLs excluded)."""
        if v is None:
            return 0.0
        idx = self._bucket_index(v)
        if idx < 0:
            if self.buckets and datum_compare(v, self.buckets[0].lower) < 0:
                return 0.0
            return float(self.not_null_count())
        b = self.buckets[idx]
        prev = self.buckets[idx - 1].count if idx > 0 else 0
        in_bucket = b.count - prev
        if datum_compare(v, b.lower) == 0:
            return float(prev)
        if datum_compare(v, b.upper) == 0:
            return float(b.count - b.repeat)
        # interpolate inside the bucket
        frac = _fraction(b.lower, b.upper, v)
        return prev + frac * in_bucket

    def greater_row_count(self, v: Datum) -> float:
        return max(0.0, self.not_null_count() - self.less_row_count(v)
                   - self.equal_row_count(v))

    def between_row_count(self, lo: Datum, hi: Datum,
                          lo_open: bool = False, hi_open: bool = True) -> float:
        """Rows in [lo, hi) by default (range semantics of util/ranger)."""
        cnt = self.less_row_count(hi) - self.less_row_count(lo)
        if not lo_open:
            pass  # lo included already (less(lo) excludes lo)
        else:
            cnt -= self.equal_row_count(lo)
        if not hi_open:
            cnt += self.equal_row_count(hi)
        return max(0.0, cnt)

    def _bucket_index(self, v: Datum) -> int:
        lo, hi = 0, len(self.buckets) - 1
        ans = -1
        while lo <= hi:
            mid = (lo + hi) // 2
            b = self.buckets[mid]
            if datum_compare(v, b.upper) <= 0:
                if datum_compare(v, b.lower) >= 0:
                    return mid
                hi = mid - 1
            else:
                lo = mid + 1
        return ans

    def to_dict(self) -> dict:
        return {"col_id": self.col_id, "ndv": self.ndv,
                "null_count": self.null_count,
                "total_count": self.total_count,
                "buckets": [[b.lower, b.upper, b.count, b.repeat]
                            for b in self.buckets]}

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls(d["col_id"], d["ndv"], d["null_count"], d["total_count"])
        h.buckets = [Bucket(*b) for b in d["buckets"]]
        return h


def _sort_key(v: Datum):
    from ..mytypes import sort_key
    return sort_key(v)


def _fraction(lo: Datum, hi: Datum, v: Datum) -> float:
    """Position of v inside (lo, hi) for interpolation."""
    try:
        a, b = coerce_for_compare(lo, hi)
        _, x = coerce_for_compare(lo, v)
        if isinstance(a, str) or isinstance(b, str):
            return 0.5
        if b == a:
            return 0.5
        return min(1.0, max(0.0, (x - a) / (b - a)))
    except Exception:
        return 0.5
